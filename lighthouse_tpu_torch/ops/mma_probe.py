"""The tensor-core probe: out[s, k, b] = sum_l M[k, l] X[s, l, b], exact,
in int8 (int32 sums) and bf16 (float32 sums) -- wrapper, plain version and
a command-line entry.

Replaces the TPU kernel `scripts/probe_mxu_forms.py` `kernel`, which timed
four formulations of this contraction inside a Pallas kernel on the TPU's
matrix unit: int8 and bf16 operands, each lowered by Mosaic as an einsum or
as a batched `dot_general`. That lowering choice has no CUDA counterpart: a
hand-written kernel states its own loop nest, so the port's two forms are
the two operand types. The CUDA source is
`lighthouse_tpu_torch/csrc/mma_probe.cu` (`mma.sync` m16n8k32 int8 and
m16n8k16 bf16, four blocks an s, X[s] transposed in registers on its way
into shared memory); the plain version sums int32 products, exact for both forms
at the probe's values (< 2^7, sums < 2^19).

    python -m lighthouse_tpu_torch.ops.mma_probe

runs both forms on the card at the probe's shapes and prints one JSON
record per form: exact against a numpy int64 einsum, the kernel's time,
the time of the PyTorch call that computes the same function
(`torch._int_mm` for int8, a float32 `torch.matmul` for bf16, since a bf16
output would round) and the bound. It needs a CUDA device and exits 2
without one; it writes no file.
"""

import json
import sys

import numpy as np
import torch

from lighthouse_tpu_torch.ops import cuda_build

S, L, K, B = 18, 32, 64, 128  # the probe's shapes
FORMS = {
    # form -> (operand dtype, C entry, launch counter, depth of one mma)
    "i8": (torch.int8, "lh_mma_probe_i8", "mma_probe_i8", 32),
    "bf16": (torch.bfloat16, "lh_mma_probe_bf16", "mma_probe_bf16", 16),
}

HBM_BYTES_PER_S = 3.35e12
# dense tensor-core rates of the H100 SXM (NVIDIA's data sheet)
TENSOR_OPS_PER_S = {"i8": 1979e12, "bf16": 989e12}


def probe_inputs(seed: int = 0):
    """M (K, L) and X (S, L, B) int32 in 0..126, drawn as the probe does."""
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 127, (K, L), dtype=np.int32)
    X = rng.integers(0, 127, (S, L, B), dtype=np.int32)
    return M, X


def reference(M, X) -> np.ndarray:
    """The probe's own check: a numpy int64 einsum."""
    return np.einsum("kl,slb->skb", np.asarray(M, np.int64), np.asarray(X, np.int64))


def operands(M, X, form: str, device):
    """Host int arrays -> the form's operand tensors on `device`."""
    dtype = FORMS[form][0]
    return (
        torch.as_tensor(np.asarray(M), device=device).to(dtype),
        torch.as_tensor(np.asarray(X), device=device).to(dtype),
    )


def contract_plain(M, X):
    """The same contraction from int32 products, any device and form."""
    Mi = M.to(torch.int32)
    Xi = X.to(torch.int32)
    return (Mi[None, :, :, None] * Xi[:, None, :, :]).sum(dim=2, dtype=torch.int32)


def contract(M, X, form: str, require_kernel: bool = False):
    """out (S, K, B) int32 from M (K, L) and X (S, L, B) of the form's
    operand type. CUDA tensors launch the probe kernel, CPU tensors run
    `contract_plain`. The kernel takes K % 64 (four warps of 16-row
    bands), B % 32 (four blocks an s, 8-column tiles) and L at most 64 (a
    warp holds its A fragments for the whole L in registers): the probe's
    one shape, 64 / 128 / 32, where an earlier design that staged
    everything in shared memory took K % 16, B % 8 and L up to 336."""
    if form not in FORMS:
        raise ValueError(f"mma_probe: unknown form {form!r}, expected one of {tuple(FORMS)}")
    dtype, entry, counter, depth = FORMS[form]
    if not cuda_build.use_kernel(X, require_kernel):
        return contract_plain(M, X)
    s, l, b = X.shape
    k = M.shape[0]
    if k % 64 or b % 32 or l % depth or l > 64:
        raise ValueError(f"mma_probe: K {k}, B {b}, L {l} must be multiples of 64, 32, {depth}"
                         " and L at most 64")
    cuda_build.check(M, "M", (k, l), X.device, dtype)
    cuda_build.check(X, "X", (s, l, b), X.device, dtype)
    out = torch.empty((s, k, b), dtype=torch.int32, device=X.device)
    cuda_build.launch("mma_probe", entry, counter, M, X, s, l, k, b, out)
    return out


def library_call(M, X, form: str):
    """The one PyTorch call that computes the same function, as a timed
    yardstick; its operands are arranged before the call (int8: X as one
    (L, S B) column-major matrix, result (K, S B)). The port never calls it."""
    if form == "i8":
        Xcat = X.permute(1, 0, 2).reshape(X.shape[1], -1).t().contiguous().t()
        return lambda: torch._int_mm(M, Xcat)
    Mf, Xf = M.float(), X.float()
    return lambda: torch.matmul(Mf, Xf)


def bound(form: str):
    """(ms, "bytes" | "operations") at the probe's shapes: each operand read
    once and the int32 result written once at the HBM rate, against
    2 S K L B operations at the form's dense tensor-core rate."""
    elem = FORMS[form][0].itemsize
    nbytes = (K * L + S * L * B) * elem + S * K * B * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * S * K * L * B / TENSOR_OPS_PER_S[form] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def probe(form: str, device="cuda") -> dict:
    """One form on the card: exactness, kernel and library times (both by
    `cuda_build.time_ms`, device work alone; `call_ms` beside them, which
    counts the host's wrapper work too), bound."""
    M_np, X_np = probe_inputs()
    M, X = operands(M_np, X_np, form, device)
    out = contract(M, X, form, require_kernel=True)
    exact = bool(np.array_equal(out.cpu().numpy().astype(np.int64), reference(M_np, X_np)))
    bound_ms, bound_by = bound(form)
    kernel = lambda: contract(M, X, form, require_kernel=True)  # noqa: E731
    library = library_call(M, X, form)
    return {
        "form": form,
        "exact": exact,
        "ms": cuda_build.time_ms(kernel, reps=5),
        "library_ms": cuda_build.time_ms(library, reps=5),
        "call_ms": cuda_build.call_ms(kernel, reps=20),
        "library_call_ms": cuda_build.call_ms(library, reps=20),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "shapes": {"S": S, "L": L, "K": K, "B": B},
        "device": torch.cuda.get_device_name(torch.device(device)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device available", file=sys.stderr)
        return 2
    records = [probe(form) for form in FORMS]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(r["exact"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
