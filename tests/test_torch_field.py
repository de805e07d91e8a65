"""The port's plain field (lighthouse_tpu_torch/ops/field.py) against the
JAX package: its pure-Python oracle (crypto/ref_fields) and its
batch-last Montgomery product (ops/tfield.mul_lazy), exactly, on the same
numpy inputs; plus the JAX <-> port bundle converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import ref_fields as rf
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu.ops import fieldb as fb
from lighthouse_tpu.ops import tfield as tf
from lighthouse_tpu_torch.ops import field as fd, programs

torch.set_num_threads(1)

R = 1 << 384
R_INV = pow(R, -1, P)
B = 6


def _values(case: str, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    if case == "edge":
        return [0, 1, P - 1, 2, P - 2, (P - 1) // 2]
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(B)]


def _mont_bundle(vals) -> torch.Tensor:
    """ints -> (1, NB, B) canonical Montgomery bundle."""
    return fd.words_to_bundle(torch.tensor(fd.mont_words(vals).T[None]))


def _ints(bundle) -> list:
    """(1, NB, B) bundle -> plain ints."""
    return fd.words_from_mont(fd.bundle_to_words(bundle)[0].T.numpy())


def _jit(fn, *args):
    opts = {"xla_backend_optimization_level": 0}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


_TF_MUL = {}


def _tf_mul(a, b):
    """The JAX package's tfield.mul_lazy, compiled once per shape."""
    key = a.shape
    if key not in _TF_MUL:
        _TF_MUL[key] = _jit(tf.mul_lazy, jnp.asarray(a), jnp.asarray(b))
    return np.asarray(_TF_MUL[key](jnp.asarray(a), jnp.asarray(b)))


def _jax_canon_ints(x) -> list:
    """JAX relaxed batch-last (1, NB, B) Montgomery -> plain ints."""
    bl = np.moveaxis(np.asarray(x), -1, 0)  # (B, 1, NB)
    return [v * R_INV % P for v in fb.unpack_ints(bl)]


@pytest.mark.parametrize("case", ["random", "edge"])
def test_pack_matches_fieldb(case):
    vals = _values(case)
    assert np.array_equal(fd.pack_ints(vals), fb.pack_ints(vals))
    assert fd.unpack_ints(fd.pack_ints(vals)) == vals


@pytest.mark.parametrize("case", ["random", "edge"])
def test_words_bundle_roundtrip(case):
    vals = _values(case, seed=1)
    w = torch.tensor(fd.ints_to_words(vals).T[None])
    b = fd.words_to_bundle(w)
    assert fd.unpack_ints(b[0].T.numpy()) == vals
    assert torch.equal(fd.bundle_to_words(b), w)
    assert fd.words_to_ints(w[0].T.numpy()) == vals


@pytest.mark.parametrize("case", ["random", "edge"])
def test_to_from_montgomery(case):
    vals = _values(case, seed=2)
    plain = torch.tensor(fd.pack_ints(vals).T[None])
    mont = fd.to_mont(plain)
    assert _ints(mont) == vals
    assert fd.words_to_ints(fd.bundle_to_words(mont)[0].T.numpy()) == [v * R % P for v in vals]
    assert fd.unpack_ints(fd.from_mont(mont)[0].T.numpy()) == vals


_REF_OPS = {
    "add": (lambda a, b: fd.add(a, b), rf.fp_add),
    "sub": (lambda a, b: fd.sub(a, b), rf.fp_sub),
    "mul": (lambda a, b: fd.mul_lazy(a, b), rf.fp_mul),
    "sqr": (lambda a, b: fd.sqr_lazy(a), lambda x, y: rf.fp_mul(x, x)),
    "neg": (lambda a, b: fd.neg(a), lambda x, y: rf.fp_neg(x)),
    "scalar12": (lambda a, b: fd.scalar_small(a, 12), lambda x, y: 12 * x % P),
    "inv": (lambda a, b: fd.inv(a), lambda x, y: rf.fp_inv(x) if x else 0),
}


@pytest.mark.parametrize("case", ["random", "edge"])
@pytest.mark.parametrize("op", sorted(_REF_OPS))
def test_op_matches_ref_fields(op, case):
    a_vals = _values(case, seed=3)
    b_vals = _values("random", seed=4)
    port, ref = _REF_OPS[op]
    got = _ints(port(_mont_bundle(a_vals), _mont_bundle(b_vals)))
    assert got == [ref(x, y) for x, y in zip(a_vals, b_vals)]


def _relaxed_inputs(seed: int):
    """Canonical limbs of values in [0, 2p): valid relaxed-limb inputs that
    are not reduced mod p."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(B)]
    vals[0], vals[1] = 0, 2 * P - 1
    limbs = [[(v >> (12 * i)) & 0xFFF for i in range(fb.NB)] for v in vals]
    return np.array(limbs, np.int32).T[None]  # (1, NB, B)


@pytest.mark.parametrize("square", [False, True], ids=["mul", "sqr"])
def test_mul_matches_tfield(square):
    a = _relaxed_inputs(5)
    b = a if square else _relaxed_inputs(6)
    ref = _tf_mul(a, b)
    got = fd.mul_lazy(torch.tensor(a), torch.tensor(b))
    assert _ints(got) == _jax_canon_ints(ref)
    # a second product on the relaxed outputs of the first
    ref2 = _tf_mul(ref, ref)
    got2 = fd.mul_lazy(got, got)
    assert _ints(got2) == _jax_canon_ints(ref2)


def test_from_jax_bundle_relaxed():
    """A relaxed JAX bundle (fieldb.to_mont output) converts to the same
    canonical Montgomery words the port packs from the integers."""
    vals = _values("random", seed=7) + _values("edge")
    jb = np.asarray(fb.to_mont(jnp.asarray(fb.pack_ints(vals))))  # (N, NB) relaxed
    words = fd.from_jax_bundle(jb)
    assert np.array_equal(words, fd.mont_words(vals))
    back = fd.to_jax_bundle(words)
    assert np.array_equal(back, fb.pack_ints([v * R % P for v in vals]))
    # leading axes are kept: (..., S, 33) -> (..., S, 12)
    shaped = fd.from_jax_bundle(jb.reshape(3, 4, fb.NB))
    assert shaped.shape == (3, 4, fd.NW)
    assert np.array_equal(shaped.reshape(-1, fd.NW), words)


@pytest.mark.parametrize("prog", ["FP2_MUL", "FP6_MUL", "FP12_MUL", "FP12_SQR", "LINE_MUL"])
def test_bilinear_matches_separate_recombinations(prog):
    """`bilinear` runs A x and B y as one block-diagonal recombination; the
    canonical product equals the one from two separate recombinations."""
    pg = getattr(programs, prog)
    rng = np.random.default_rng(len(prog))

    def operand(slots):
        vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(slots * 2)]
        return fd.words_to_bundle(torch.tensor(fd.mont_words(vals).reshape(slots, 2, fd.NW).transpose(0, 2, 1)))

    x, y = operand(pg.A.shape[1]), operand(pg.B.shape[1])
    if prog == "FP12_SQR":
        y = x
    want = fd.apply_combo(fd.mul_lazy(fd.apply_combo(x, pg.A), fd.apply_combo(y, pg.B)), pg.C)
    assert torch.equal(fd.bundle_to_words(fd.bilinear(x, y, pg)), fd.bundle_to_words(want))
