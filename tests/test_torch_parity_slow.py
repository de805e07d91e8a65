"""Whole-graph parity of the port's plain versions with the JAX package,
exactly (canonical words): the transposed Miller loop before the final
exponentiation, the lane fold plus final exponentiation, the windowed RLC
ladder, and the Pallas batch verify in interpret mode.

Marked slow: each JAX reference is a whole jitted graph whose cold compile
takes minutes on a CPU (the Miller loop alone about a minute, the final
exponentiation about a minute and a half).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu import testing as td
from lighthouse_tpu.crypto import ref_curve as rc
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu.ops import batch_verify as jbv
from lighthouse_tpu.ops import fieldb as fb
from lighthouse_tpu.ops import tcurve, tfexp as jfe, tpairing as jtp
from lighthouse_tpu.ops import window_ladder as jwl
from lighthouse_tpu_torch.ops import batch_verify, curve, field as fd
from lighthouse_tpu_torch.ops import tfexp, tpairing
from lighthouse_tpu_torch.ops import window_ladder as wl

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

R = 1 << 384


def _bundle(lanes):
    """[lane][slot] plain ints -> (slots, NB, lanes) Montgomery limbs."""
    limbs = np.array([fb.pack_ints([v * R % P for v in lane]) for lane in lanes], np.int32)
    return np.ascontiguousarray(np.moveaxis(limbs, 0, -1))


def _canon(x):
    """Port or JAX relaxed bundle -> canonical kernel words (exact compare)."""
    return fd.bundle_to_words(torch.as_tensor(np.array(x))).numpy()


def _coords(v, w):
    return [v] if w == 1 else list(v)


def test_miller_loop_t_matches():
    """Two live pairs and one masked pair, the value before the final
    exponentiation (the line scaling of tpairing, not just the pairing)."""
    g1s = [rc.G1.to_affine(rc.G1.mul_scalar(rc.G1.generator, k)) for k in (3, 5, 7)]
    g2s = [rc.G2.to_affine(rc.G2.mul_scalar(rc.G2.generator, k)) for k in (11, 13, 17)]
    p = (_bundle([[a[0]] for a in g1s]), _bundle([[a[1]] for a in g1s]))
    q = (_bundle([list(b[0]) for b in g2s]), _bundle([list(b[1]) for b in g2s]))
    mask = np.array([True, False, True])
    want = jax.jit(jtp.miller_loop_t)(
        tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)), jnp.asarray(mask)
    )
    got = tpairing.miller_loop_t(
        tuple(map(torch.as_tensor, p)), tuple(map(torch.as_tensor, q)), torch.as_tensor(mask)
    )
    assert np.array_equal(_canon(got), _canon(want))


def test_fold_and_final_exponentiation_match():
    rng = np.random.default_rng(7)
    lanes = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)] for _ in range(3)]
    f = _bundle(lanes)
    frob = jnp.asarray(jfe.frob_consts())[:, :, None]

    def jax_tail(x):
        return jfe.final_exponentiation_t(jfe.fold_lanes(x), frob[:12], frob[12:])

    want = jax.jit(jax_tail)(jnp.asarray(f))
    got = tfexp.final_exponentiation_t(tfexp.fold_lanes(torch.as_tensor(f)))
    assert np.array_equal(_canon(got), _canon(want))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_windowed_ladder_matches(name):
    """64-bit scalars (zero, one, all ones, random) with an identity lane,
    projective X:Y:Z compared exactly."""
    w, G, tg = {"G1": (1, rc.G1, tcurve.TPG1), "G2": (2, rc.G2, tcurve.TPG2)}[name]
    affs = [G.to_affine(G.mul_scalar(G.generator, k)) for k in (3, 5, 9, 17)]
    lanes_x = [_coords(a[0], w) for a in affs]
    lanes_y = [_coords(a[1], w) for a in affs]
    lanes_z = [[1] + [0] * (w - 1) for _ in affs]
    lanes_x[1], lanes_y[1], lanes_z[1] = [0] * w, [1] + [0] * (w - 1), [0] * w  # identity
    pt = tuple(_bundle(c) for c in (lanes_x, lanes_y, lanes_z))
    scalars = [0, 1, (1 << 64) - 1, 0x9E3779B97F4A7C15]
    bits = np.ascontiguousarray(wl.scalars_to_bits(scalars, 64).T)  # (64, B)

    def jax_ladder(X, Y, Z, b):
        return jwl.mul_scalar_bits_windowed_t(tg, (X, Y, Z), b)

    want = jax.jit(jax_ladder)(*map(jnp.asarray, pt), jnp.asarray(bits))
    got = wl.mul_scalar_bits_windowed_t(
        curve.group(w), tuple(map(torch.as_tensor, pt)), torch.as_tensor(bits)
    )
    for a, b in zip(got, want):
        assert np.array_equal(_canon(a), _canon(b))


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_batch_verify_matches_pallas_interpret(corrupt):
    """The JAX package's Pallas verify (interpret mode, block_b=4, as its own
    tests run it) and the port's flat verify on the same S = 2 batch."""
    args = td.make_signature_set_batch(
        2, max_keys=2, seed=2, corrupt_indices=(1,) if corrupt else ()
    )
    fn = functools.partial(jbv.verify_signature_sets_pallas, block_b=4, interpret=True)
    want = bool(np.asarray(jax.jit(fn)(*args)))
    msgs, sigs, pks, km, rb, sm = args
    port_args = (
        tuple(fd.from_jax_bundle(c) for c in msgs),
        tuple(fd.from_jax_bundle(c) for c in sigs),
        tuple(fd.from_jax_bundle(c) for c in pks),
        np.asarray(km),
        np.asarray(rb),
        np.asarray(sm),
    )
    got = bool(batch_verify.verify_signature_sets(*port_args, device="cpu"))
    assert got == want == (not corrupt)
