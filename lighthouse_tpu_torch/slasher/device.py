"""The slasher's min/max-target arrays on the card: batched updates and
surround detection.

The port of `lighthouse_tpu/slasher/device.py`. For the (V, H) int32 arrays

    max_targets[v][e] = max target over v's attestations with source <= e
    min_targets[v][e] = min target over v's attestations with source >= e

a batch of attestations (v, s, t) with a validity mask updates both (a
scatter of the batch's extremes at the source column, then a running
extremum along the epoch axis, merged with the old arrays), and each valid
lane gets two verdicts from the UPDATED arrays:

    surrounded = s > 0 and max_targets[v][s-1] > t
    surrounds  = s + 1 < H and min_targets[v][s+1] < t

which catch both earlier attestations and pairs within the batch.

Unlike the reference, `batch_update` writes the updated arrays INTO the
tensors it is given and returns them: at ~1 M validators x 4,096 epochs
the two arrays are 32 GiB, and the functional form's copies and (V, H)
temporaries do not fit on one card. Invalid lanes change nothing and give
False whatever their v, s and t; a VALID lane outside 0 <= v < V,
0 <= s < H breaks the contract ("pre-windowed by the caller") and raises
ValueError on every device.

CUDA tensors launch `csrc/slasher_update.cu` (one block a touched row,
after `group_lanes` sorts the lanes by row); CPU tensors run
`batch_update_plain`. The kernel reads and writes only the columns a
row's lanes can change: max from the row's smallest source up, min up to
its largest. Elsewhere the reference's merge with its sentinels leaves an
entry as it is, for any max array whose entries are >= NO_TARGET_MAX, as
in every array built from sentinels by updates.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, device_io

NO_TARGET_MIN = torch.iinfo(torch.int32).max
NO_TARGET_MAX = -1


def _check_range(v_idx, s, valid, V: int, H: int) -> None:
    bad = valid & ((v_idx < 0) | (v_idx >= V) | (s < 0) | (s >= H))
    if bool(bad.any()):
        lane = int(torch.nonzero(bad)[0, 0])
        raise ValueError(
            f"lane {lane}: a valid attestation outside the window (v={int(v_idx[lane])}, "
            f"s={int(s[lane])}; V={V}, H={H})")


def update_bytes(v_idx, s, valid, H: int) -> int:
    """Bytes a batch's update must move: for each touched row with sources
    in [lo, hi], the max columns [lo, H) and the min columns [0, hi] read
    and written once; each lane's v, s, t and mask read once, its two
    verdicts written once. (v_idx, s, valid) lie on any device."""
    valid = valid.to(torch.bool)
    rows, inverse = torch.unique(v_idx[valid].to(torch.int64), return_inverse=True)
    sv = s[valid].to(torch.int64)
    lo = torch.full((rows.numel(),), H, dtype=torch.int64, device=sv.device)
    hi = torch.full((rows.numel(),), -1, dtype=torch.int64, device=sv.device)
    lo.scatter_reduce_(0, inverse, sv, "amin")
    hi.scatter_reduce_(0, inverse, sv, "amax")
    columns = int(((H - lo) + (hi + 1)).sum())
    return columns * 4 * 2 + int(v_idx.shape[0]) * (3 * 4 + 1 + 2)


def row_bytes(rows: int, H: int, n: int) -> int:
    """`update_bytes` if every touched row were read and written whole in
    both arrays."""
    return rows * H * 4 * 2 * 2 + n * (3 * 4 + 1 + 2)


def batch_update_plain(min_arr, max_arr, v_idx, s, t, valid):
    """The reference's `batch_update` in torch on any device, in place:
    scatter_reduce (amax / amin) into arrays of sentinels, cummax and a
    flipped cummin along the epoch axis, the merge, the gathers."""
    V, H = max_arr.shape
    valid = valid.to(torch.bool)
    _check_range(v_idx, s, valid, V, H)
    v_safe = torch.where(valid, v_idx, 0).to(torch.int64)
    s_safe = torch.where(valid, s, 0).to(torch.int64)
    t_max = torch.where(valid, t, NO_TARGET_MAX).to(torch.int32)
    t_min = torch.where(valid, t, NO_TARGET_MIN).to(torch.int32)
    flat = v_safe * H + s_safe
    dev = max_arr.device
    scat_max = torch.full((V * H,), NO_TARGET_MAX, dtype=torch.int32, device=dev)
    scat_max.scatter_reduce_(0, flat, t_max, "amax")
    scat_min = torch.full((V * H,), NO_TARGET_MIN, dtype=torch.int32, device=dev)
    scat_min.scatter_reduce_(0, flat, t_min, "amin")
    run_max = torch.cummax(scat_max.view(V, H), dim=1).values
    del scat_max
    run_min = torch.cummin(scat_min.view(V, H).flip(1), dim=1).values.flip(1)
    del scat_min
    torch.maximum(max_arr, run_max, out=max_arr)
    del run_max
    torch.minimum(min_arr, run_min, out=min_arr)
    del run_min
    s_prev = torch.clamp(s_safe - 1, 0, H - 1)
    s_next = torch.clamp(s_safe + 1, 0, H - 1)
    surrounded = valid & (s_safe > 0) & (max_arr[v_safe, s_prev] > t)
    surrounds = valid & (s_safe + 1 < H) & (min_arr[v_safe, s_next] < t)
    return min_arr, max_arr, surrounded, surrounds


def group_lanes(v_idx, s, valid, V: int, H: int):
    """The kernel's glue: (keys, order, ends). `keys` is each lane's row
    (V for an invalid lane) sorted stably, `order` the lane at each sorted
    position, `ends[p]` the position after p's segment, so the lanes of a
    row are order[p0:ends[p0]] for the segment's first position p0.
    Raises ValueError for a valid lane out of range."""
    valid = valid.to(torch.bool)
    _check_range(v_idx, s, valid, V, H)
    key = torch.where(valid, v_idx, V).to(torch.int32)
    keys, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(keys, keys, right=True, out_int32=True)
    return keys.contiguous(), order.contiguous(), ends.contiguous()


def launch_rows(min_arr, max_arr, groups, s, t, surrounded, surrounds) -> None:
    """One launch of the row kernel on grouped lanes (no check, no sync):
    what `batch_update` runs after `group_lanes`, apart for timing."""
    keys, order, ends = groups
    V, H = max_arr.shape
    cuda_build.launch("slasher_update", "lh_slasher_update", "slasher_update", min_arr, max_arr,
                      V, H, keys, order, ends, s, t, int(keys.shape[0]), surrounded, surrounds)


def batch_update(min_arr, max_arr, v_idx, s, t, valid, device="cuda",
                 require_kernel: bool = False):
    """Apply a batch to the (V, H) int32 arrays IN PLACE. The arrays live on
    `device` ("cuda": the kernel; "cpu": `batch_update_plain`); v_idx, s, t
    ((N,) int32) and valid ((N,) bool) are tensors, moved there. Returns
    (min_arr, max_arr, surrounded, surrounds), the verdicts (N,) bool on
    `device`."""
    dev = device_io.resolve_device(device)
    for name, a in (("min_arr", min_arr), ("max_arr", max_arr)):
        if not isinstance(a, torch.Tensor) or a.device.type != dev.type:
            where = a.device if isinstance(a, torch.Tensor) else type(a).__name__
            raise ValueError(f"{name}: the arrays must live on {dev}, got {where}")
    v_idx, s, t, valid = (x.to(max_arr.device) for x in (v_idx, s, t, valid))
    if not cuda_build.use_kernel(max_arr, require_kernel):
        return batch_update_plain(min_arr, max_arr, v_idx, s, t, valid)
    V, H = (int(x) for x in max_arr.shape)
    n = int(v_idx.shape[0])
    dev = max_arr.device
    cuda_build.check(min_arr, "min_arr", (V, H), dev)
    cuda_build.check(max_arr, "max_arr", (V, H), dev)
    for name, tensor in (("v_idx", v_idx), ("s", s), ("t", t)):
        cuda_build.check(tensor, name, (n,), dev)
    cuda_build.check(valid, "valid", (n,), dev, torch.bool)
    if H % 4 == 0 and (min_arr.data_ptr() % 16 or max_arr.data_ptr() % 16):
        raise ValueError("min_arr, max_arr: the kernel reads 16-byte aligned rows")
    groups = group_lanes(v_idx, s, valid, V, H)
    surrounded = torch.zeros(n, dtype=torch.bool, device=dev)
    surrounds = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        launch_rows(min_arr, max_arr, groups, s, t, surrounded, surrounds)
    return min_arr, max_arr, surrounded, surrounds
