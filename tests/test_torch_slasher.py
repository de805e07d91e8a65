"""The port's slasher plane (lighthouse_tpu_torch.slasher.device) against
the JAX package's `batch_update_jit` and brute-force surround semantics,
on the CPU; the kernel's row-grouping glue and a model of its row
algorithm against the plain version."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.slasher.device import batch_update_jit
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.slasher import device as sd
from lighthouse_tpu_torch.slasher.device import NO_TARGET_MAX, NO_TARGET_MIN

update = functools.partial(sd.batch_update, device="cpu")


def _arrays(V, H):
    return (torch.full((V, H), NO_TARGET_MIN, dtype=torch.int32),
            torch.full((V, H), NO_TARGET_MAX, dtype=torch.int32))


def _batch(rng, V, H, n, invalid=0.2):
    """Random lanes: duplicate (v, s) pairs, several lanes a row, s = 0 and
    s = H - 1, and invalid lanes with garbage v, s and t."""
    v = rng.integers(0, max(1, V // 4), n).astype(np.int32)
    s = rng.integers(0, H, n).astype(np.int32)
    t = np.minimum(s + rng.integers(0, H // 2 + 1, n), H - 1).astype(np.int32)
    s[: n // 8] = 0
    s[n // 8: n // 4] = H - 1
    t[n // 8: n // 4] = H - 1
    v[n // 4: n // 4 + 4] = v[0]
    s[n // 4: n // 4 + 4] = s[0]  # duplicate (v, s) pairs
    valid = rng.random(n) >= invalid
    bad = ~valid
    v[bad] = rng.integers(-2**31, 2**31 - 1, bad.sum())
    s[bad] = rng.integers(-2**31, 2**31 - 1, bad.sum())
    t[bad] = rng.integers(-2**31, 2**31 - 1, bad.sum())
    return v, s, t, valid


def _reference(min_arr, max_arr, v, s, t, valid):
    out = batch_update_jit(jnp.asarray(min_arr.numpy()), jnp.asarray(max_arr.numpy()),
                           jnp.asarray(v), jnp.asarray(s), jnp.asarray(t), jnp.asarray(valid))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("V, H, n", [(16, 32, 64), (64, 128, 300)], ids=["16x32", "64x128"])
def test_plain_equals_reference_with_a_prior(V, H, n):
    rng = np.random.default_rng(V)
    min_arr, max_arr = _arrays(V, H)
    for step in range(2):  # the first batch is the second's prior
        v, s, t, valid = _batch(rng, V, H, n)
        want = _reference(min_arr, max_arr, v, s, t, valid)
        got = update(min_arr, max_arr, *(torch.from_numpy(a) for a in (v, s, t, valid)))
        assert got[0] is min_arr and got[1] is max_arr  # in place
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w), step
        assert got[2].any() or got[3].any() or step == 0


def _brute_force(atts):
    surrounded = [False] * len(atts)
    surrounds = [False] * len(atts)
    for i, (v1, s1, t1) in enumerate(atts):
        for j, (v2, s2, t2) in enumerate(atts):
            if i != j and v1 == v2:
                surrounded[i] |= s2 < s1 and t2 > t1
                surrounds[i] |= s2 > s1 and t2 < t1
    return surrounded, surrounds


def test_randomized_against_brute_force():
    rnd = random.Random(13)
    V, H = 8, 16
    for trial in range(20):
        atts = []
        for _ in range(rnd.randrange(2, 20)):
            s = rnd.randrange(0, H - 1)
            atts.append((rnd.randrange(V), s, rnd.randrange(s, H)))
        cols = [torch.tensor(c, dtype=torch.int32) for c in zip(*atts)]
        _, _, surrounded, surrounds = update(
            *_arrays(V, H), *cols, torch.ones(len(atts), dtype=torch.bool))
        assert (surrounded.tolist(), surrounds.tolist()) == _brute_force(atts), trial


def test_prior_surrounds_and_masked_lanes():
    min_arr, max_arr = _arrays(4, 8)
    lanes = lambda *c: [torch.tensor(x, dtype=torch.int32) for x in c]  # noqa: E731
    update(min_arr, max_arr, *lanes([1], [2], [6]), torch.tensor([True]))
    _, _, surrounded, _ = update(min_arr.clone(), max_arr.clone(), *lanes([1], [3], [4]),
                                          torch.tensor([True]))
    _, _, _, surrounds = update(min_arr.clone(), max_arr.clone(), *lanes([1], [1], [7]),
                                         torch.tensor([True]))
    assert surrounded.tolist() == [True] and surrounds.tolist() == [True]
    # a masked (0, 1, 7) neither writes nor flags (0, 2, 3)
    new_min, new_max, surrounded, _ = update(
        *_arrays(4, 8), *lanes([0, 0], [1, 2], [7, 3]), torch.tensor([False, True]))
    assert surrounded.tolist() == [False, False] and int(new_max[0, 1]) == NO_TARGET_MAX


def test_in_place_contract():
    """The arrays given are the arrays returned, updated; a caller that
    needs the old ones clones first."""
    rng = np.random.default_rng(3)
    min_arr, max_arr = _arrays(16, 32)
    v, s, t, valid = (torch.from_numpy(a) for a in _batch(rng, 16, 32, 40, invalid=0.0))
    old_min, old_max = min_arr.clone(), max_arr.clone()
    got_min, got_max, _, _ = update(min_arr, max_arr, v, s, t, valid)
    assert got_min.data_ptr() == min_arr.data_ptr() and got_max.data_ptr() == max_arr.data_ptr()
    assert not torch.equal(old_max, max_arr) and not torch.equal(old_min, min_arr)
    again = update(old_min.clone(), old_max.clone(), v, s, t, valid)
    assert torch.equal(again[0], min_arr) and torch.equal(again[1], max_arr)
    # idempotent: the same batch again changes nothing
    update(min_arr, max_arr, v, s, t, valid)
    assert torch.equal(again[0], min_arr) and torch.equal(again[1], max_arr)


@pytest.mark.parametrize("lane", [(4, 0), (-1, 0), (0, 8), (0, -1)], ids=["v=V", "v<0", "s=H", "s<0"])
def test_valid_lane_out_of_range_raises(lane):
    min_arr, max_arr = _arrays(4, 8)
    old = max_arr.clone()
    v = torch.tensor([1, lane[0]], dtype=torch.int32)
    s = torch.tensor([2, lane[1]], dtype=torch.int32)
    t = torch.tensor([5, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the window"):
        update(min_arr, max_arr, v, s, t, torch.tensor([True, True]))
    with pytest.raises(ValueError, match="outside the window"):
        sd.group_lanes(v, s, torch.tensor([True, True]), 4, 8)
    assert torch.equal(max_arr, old)
    # the same lane masked off is fine
    update(min_arr, max_arr, v, s, t, torch.tensor([True, False]))


def _row_model(min_arr, max_arr, groups, s, t, warps=8):
    """The row kernel's algorithm in numpy, from `group_lanes`' output: a
    row's lanes are order[p0:ends[p0]]; the scatter with the row's smallest
    and largest source; each warp's stretch scanned alone, then its
    carry-in from the other stretches' totals; the merge of the needed
    columns only (max from the smallest source up, min to the largest,
    rounded out to 4-element groups when H % 4 == 0); the verdicts from
    the merged columns, else from the row."""
    keys, order, ends = (g.numpy() for g in groups)
    V, H = max_arr.shape
    mn, mx = min_arr.numpy().copy(), max_arr.numpy().copy()
    n = len(keys)
    surrounded = np.zeros(n, bool)
    surrounds = np.zeros(n, bool)
    stretch = ((-(-H // warps)) + 3) & ~3
    for p0 in range(n):
        v = keys[p0]
        if v >= V or (p0 > 0 and keys[p0 - 1] == v):
            continue
        lanes = order[p0:ends[p0]]
        smax = np.full(H, NO_TARGET_MAX, np.int64)
        smin = np.full(H, NO_TARGET_MIN, np.int64)
        for lane in lanes:
            smax[s[lane]] = max(smax[s[lane]], t[lane])
            smin[s[lane]] = min(smin[s[lane]], t[lane])
        bounds = [(min(w * stretch, H), min(w * stretch + stretch, H)) for w in range(warps)]
        tot_max, tot_min = [], []
        for lo, hi in bounds:
            smax[lo:hi] = np.maximum.accumulate(smax[lo:hi]) if hi > lo else smax[lo:hi]
            smin[lo:hi] = np.minimum.accumulate(smin[lo:hi][::-1])[::-1] if hi > lo else smin[lo:hi]
            tot_max.append(smax[hi - 1] if hi > lo else -2**31)
            tot_min.append(smin[lo] if hi > lo else 2**31 - 1)
        for w, (lo, hi) in enumerate(bounds):
            smax[lo:hi] = np.maximum(smax[lo:hi], max([-2**31] + tot_max[:w]))
            smin[lo:hi] = np.minimum(smin[lo:hi], min([2**31 - 1] + tot_min[w + 1:]))
        lo, hi = min(s[lanes]), max(s[lanes])
        max_lo, min_hi = (lo & ~3, (hi + 4) & ~3) if H % 4 == 0 else (lo, hi + 1)
        mx[v, max_lo:] = np.maximum(mx[v, max_lo:], smax[max_lo:])
        mn[v, :min_hi] = np.minimum(mn[v, :min_hi], smin[:min_hi])
        for lane in lanes:
            surrounded[lane] = s[lane] > 0 and mx[v][s[lane] - 1] > t[lane]
            surrounds[lane] = s[lane] + 1 < H and mn[v][s[lane] + 1] < t[lane]
    return mn, mx, surrounded, surrounds


@pytest.mark.parametrize("V, H, n", [(16, 37, 90), (32, 64, 200), (256, 37, 48), (256, 64, 48)],
                         ids=["H37", "H64", "H37_sparse", "H64_sparse"])
def test_row_grouping_glue_and_row_model(V, H, n):
    rng = np.random.default_rng(H)
    min_arr, max_arr = _arrays(V, H)
    update(min_arr, max_arr, *(torch.from_numpy(a) for a in _batch(rng, V, H, n)))
    v, s, t, valid = _batch(rng, V, H, n)
    tv, ts, tt, tvalid = (torch.from_numpy(a) for a in (v, s, t, valid))
    groups = sd.group_lanes(tv, ts, tvalid, V, H)
    keys, order, ends = groups
    assert keys.dtype == torch.int32 and ends.dtype == torch.int32 and order.dtype == torch.int64
    # every lane once; a row's lanes contiguous, in lane order; invalid last
    assert sorted(order.tolist()) == list(range(n))
    assert keys.tolist() == sorted(np.where(valid, v, V).tolist())
    for p in range(n):
        seg = [q for q in range(n) if keys[q] == keys[p]]
        assert int(ends[p]) == seg[-1] + 1 and order[seg].tolist() == sorted(order[seg].tolist())
    touched = sorted(set(v[valid].tolist()))
    assert keys[:int(valid.sum())].unique().tolist() == touched
    model = _row_model(min_arr, max_arr, groups, s, t)
    before = dict(cuda_build.LAUNCHES)
    plain = update(min_arr.clone(), max_arr.clone(), tv, ts, tt, tvalid)
    assert cuda_build.LAUNCHES == before
    for m, p in zip(model, plain):
        assert np.array_equal(m, p.numpy())
    needed = sum((H - min(s[valid & (v == r)])) + (max(s[valid & (v == r)]) + 1) for r in touched)
    assert sd.update_bytes(tv, ts, tvalid, H) == needed * 8 + n * 15
    assert sd.row_bytes(len(touched), H, n) == len(touched) * H * 16 + n * 15


def test_arrays_on_another_device_are_refused():
    min_arr, max_arr = _arrays(4, 8)
    lanes = [torch.zeros(1, dtype=torch.int32)] * 3 + [torch.ones(1, dtype=torch.bool)]
    with pytest.raises(ValueError, match="must live on"):
        sd.batch_update(min_arr.numpy(), max_arr, *lanes, device="cpu")
    _, _, surrounded, _ = update(min_arr, max_arr, *lanes)
    assert surrounded.tolist() == [False] and int(max_arr[0, 0]) == 0


def test_honest_prior_and_planted_batches():
    """The chip run's full-width fixtures at V = 256, H = 64: the prior's
    formula equals its votes applied, and the two batches flag exactly the
    planted lanes."""
    V, H = 256, 64
    min_row, max_row = T.honest_prior(H)
    e = np.arange(1, H - 2)
    votes = [np.repeat(np.arange(3), len(e)), np.tile(e - 1, 3), np.tile(e, 3)]
    got = update(*_arrays(3, H), *(torch.from_numpy(a.astype(np.int32)) for a in votes),
                 torch.ones(3 * len(e), dtype=torch.bool))
    assert all((got[0].numpy() == min_row).all(1)) and all((got[1].numpy() == max_row).all(1))
    min_arr = torch.from_numpy(np.tile(min_row, (V, 1)))
    max_arr = torch.from_numpy(np.tile(max_row, (V, 1)))
    slot, slot_planted, epoch, epoch_planted = T.slasher_batches(V, H, 64, 4, seed=1)
    _, _, surrounded, surrounds = update(min_arr, max_arr, *map(torch.from_numpy, slot),
                                         torch.ones(68, dtype=torch.bool))
    assert not surrounded.any() and np.nonzero(surrounds.numpy())[0].tolist() == slot_planted.tolist()
    _, _, surrounded, surrounds = update(min_arr, max_arr, *map(torch.from_numpy, epoch),
                                         torch.ones(V, dtype=torch.bool))
    assert not surrounds.any() and np.nonzero(surrounded.numpy())[0].tolist() == epoch_planted.tolist()
    assert len(slot_planted) == len(epoch_planted) == 4
