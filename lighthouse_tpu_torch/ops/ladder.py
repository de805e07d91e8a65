"""K1: the per-lane RLC scalar ladders -- wrapper and plain versions.

Replaces the TPU kernels of `lighthouse_tpu/ops/pallas_ladder.py`, one body
per `form`, the counterpart of `ladder_pallas(kind=...)`:

  "window" -- `_ladder_kernel_w4`, signed digits c = 4 (the verify path's
              default); operands (mags, negs), the window-major digits of
              `window_ladder.recode_bits`;
  "chain"  -- `_ladder_kernel`, the per-bit double-add chain; operand the
              (n_bits, B) LSB-first bits;
  "w2"     -- `_ladder_kernel_w2`, the 2-bit unsigned window; operand the
              same bits, turned into MSB-first digits by
              `window_ladder.digits_w2` (on the tensors' device).

The CUDA source is `lighthouse_tpu_torch/csrc/ladder.cu`: one body for the
three forms, running the rows of `ops/ladder_rows.py` on two threads a
lane through each form's schedule of steps (`ladder_rows.steps`). A lane's
points outside its shared-memory file -- the window forms' table, the
chain's accumulator and addend, `ladder_rows.ENTRIES[form]` points -- live
in a scratch tensor that this wrapper allocates (85 MB for 32,768 G2 lanes
in the window form). The plain versions are the ports of
`window_ladder.mul_scalar_bits_windowed_t` and
`tcurve.mul_scalar_bits` / `mul_scalar_bits_w2` over `ops/curve.py`.

Operands are kernel words: a point (X, Y, Z), each (w, 12, B) int32
canonical Montgomery words, w = 1 for G1 and 2 for G2; digits and bits are
(n, B) int32.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, curve, field as fd
from lighthouse_tpu_torch.ops import ladder_rows as lr
from lighthouse_tpu_torch.ops import window_ladder as wl

FORMS = ("window", "chain", "w2")


def _check_form(form: str, operands) -> None:
    if form not in FORMS:
        raise ValueError(f"ladder: unknown form {form!r}, expected one of {FORMS}")
    want = 2 if form == "window" else 1
    if len(operands) != want:
        raise ValueError(f"ladder: form {form!r} takes {want} digit operand(s), got {len(operands)}")


def ladder_plain(pt, *operands, form: str = "window"):
    """The same function on bundles, any device."""
    _check_form(form, operands)
    group = curve.group(pt[0].shape[0])
    bundles = tuple(fd.words_to_bundle(c) for c in pt)
    if form == "window":
        mags, negs = operands
        acc = wl.mul_digits_windowed_t(group, bundles, mags, negs.to(torch.bool))
    elif form == "chain":
        acc = wl.mul_scalar_bits_chain_t(group, bundles, operands[0])
    else:
        acc = wl.mul_scalar_bits_w2_t(group, bundles, operands[0])
    return tuple(fd.bundle_to_words(c) for c in acc)


def ladder(pt, *operands, form: str = "window", require_kernel: bool = False):
    """Per-lane [k] P: `ladder(pt, mags, negs)` for the signed window,
    `ladder(pt, bits, form="chain" | "w2")` for the other bodies. CUDA
    tensors launch K1's body for `form`, CPU tensors run `ladder_plain`."""
    _check_form(form, operands)
    X = pt[0]
    if not cuda_build.use_kernel(X, require_kernel):
        return ladder_plain(pt, *operands, form=form)
    w, _, B = X.shape
    if w not in (1, 2):
        raise ValueError(f"ladder: coordinate width {w}, expected 1 or 2")
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    if form == "w2":
        operands = (wl.digits_w2(operands[0]),)
    n = operands[0].shape[0]
    for name, d in zip(("digits", "signs"), operands):
        cuda_build.check(d, name, (n, B), X.device)
    out = tuple(torch.empty_like(X) for _ in range(3))
    if B:
        suffix = "" if form == "window" else f"_{form}"
        # the form's scratch points a lane, [lane][entry][coordinate][word]
        scratch = torch.empty((B, lr.ENTRIES[form], 3 * w, fd.NW), dtype=torch.int32,
                              device=X.device)
        cuda_build.launch("ladder", f"lh_ladder_g{w}{suffix}", f"ladder_g{w}{suffix}", *pt,
                          *operands, n, B, scratch, *out)
    return out
