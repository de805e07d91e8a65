"""The port's tensor-core probe (lighthouse_tpu_torch/ops/mma_probe.py): its
plain version against the probe's own check, a numpy int64 einsum, at the
probe's shapes for both operand types (scripts/probe_mxu_forms.py draws the
same inputs), and the wrapper's refusals. The kernel itself runs only on
the card (chip_smoke.py, `python -m lighthouse_tpu_torch.ops.mma_probe`)."""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.ops import cuda_build, mma_probe

torch.set_num_threads(1)


@pytest.mark.parametrize("form", ["i8", "bf16"])
def test_plain_matches_numpy_einsum(form):
    M, X = mma_probe.probe_inputs(seed=0)
    assert M.shape == (64, 32) and X.shape == (18, 32, 128)
    assert M.min() >= 0 and max(M.max(), X.max()) == 126
    m, x = mma_probe.operands(M, X, form, "cpu")
    assert m.dtype == mma_probe.FORMS[form][0]
    out = mma_probe.contract(m, x, form)
    assert out.dtype == torch.int32 and out.shape == (18, 64, 128)
    assert np.array_equal(out.numpy().astype(np.int64), mma_probe.reference(M, X))


def test_bound_is_the_bytes_at_the_probe_size():
    for form in mma_probe.FORMS:
        ms, by = mma_probe.bound(form)
        assert by == "bytes" and 1e-4 < ms < 1e-3


def test_wrapper_refuses_unknown_form_and_cpu_kernel():
    m, x = mma_probe.operands(*mma_probe.probe_inputs(), "i8", "cpu")
    with pytest.raises(ValueError, match="unknown form"):
        mma_probe.contract(m, x, "fp8")
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel was requested for a CPU tensor"):
        mma_probe.contract(m, x, "i8", require_kernel=True)
    assert cuda_build.LAUNCHES == before


def test_main_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    assert mma_probe.main() == 2
    assert capsys.readouterr().out == ""
