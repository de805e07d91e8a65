"""The port's epoch plane (lighthouse_tpu_torch.state_processing) against
the JAX package, exactly, on the CPU.

The same state goes to both packages as SSZ bytes (`types.carry`); the
port runs the rewards pass's plain version (device="cpu") and the
reference its jitted `_kernel`. Balances, inactivity scores and, across
epoch boundaries, state roots must be equal."""

import random

import numpy as np
import pytest
import torch

from lighthouse_tpu.harness import Harness
from lighthouse_tpu.state_processing import epoch_kernel as ref_kernel
from lighthouse_tpu.state_processing.per_epoch import _AltairContext as RefAltairContext
from lighthouse_tpu.state_processing.per_epoch import process_epoch as ref_process_epoch
from lighthouse_tpu.state_processing.per_slot import process_slots as ref_process_slots
from lighthouse_tpu.types.containers import types_for as ref_types_for
from lighthouse_tpu.types.spec import (
    FAR_FUTURE_EPOCH,
    mainnet_spec,
    minimal_spec,
    spec_to_config_yaml,
)
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.state_processing import epoch_kernel
from lighthouse_tpu_torch.state_processing.per_epoch import _AltairContext, process_epoch
from lighthouse_tpu_torch.state_processing.per_slot import process_slots
from lighthouse_tpu_torch.types.carry import spec_from_reference_yaml, state_from_ssz

EPOCH = 6


def _randomize(state, spec, rnd, n_validators, leak):
    """A randomized_state-style altair state (tests/test_epoch_kernel.py):
    random effective balances, slashings, activation / exit / withdrawable
    epochs (FAR_FUTURE among them), balances, flags and scores."""
    v0 = state.validators[0]
    state.finalized_checkpoint.epoch = 0 if leak else EPOCH - 1
    inc = spec.EFFECTIVE_BALANCE_INCREMENT
    while len(state.validators) < n_validators:
        v = v0.copy()
        v.effective_balance = rnd.randrange(0, 33) * inc
        v.slashed = rnd.random() < 0.1
        v.activation_epoch = rnd.choice([0, 2, EPOCH, FAR_FUTURE_EPOCH])
        v.exit_epoch = rnd.choice([FAR_FUTURE_EPOCH, EPOCH - 1, EPOCH + 2])
        v.withdrawable_epoch = rnd.choice([FAR_FUTURE_EPOCH, EPOCH, EPOCH + 64])
        state.validators.append(v)
        state.balances.append(rnd.randrange(0, 40 * inc))
        state.previous_epoch_participation.append(rnd.randrange(0, 8))
        state.current_epoch_participation.append(rnd.randrange(0, 8))
        state.inactivity_scores.append(rnd.randrange(0, 200))
    for i in range(len(state.validators)):
        state.previous_epoch_participation[i] = rnd.randrange(0, 8)
        state.inactivity_scores[i] = rnd.randrange(0, 200)
    state.balances[1] = 3  # driven below zero by its penalties
    return state


def _pair(spec, n_validators, seed, leak):
    """(reference state, port state, port spec): equal states in both
    packages' types."""
    rnd = random.Random(seed)
    state = Harness(spec, 8).state
    state.slot = EPOCH * spec.SLOTS_PER_EPOCH
    _randomize(state, spec, rnd, n_validators, leak)
    pspec = spec_from_reference_yaml(spec_to_config_yaml(spec))
    return state, state_from_ssz(type(state).encode(state), pspec, "altair"), pspec


ALTAIR = minimal_spec(ALTAIR_FORK_EPOCH=0)


@pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rewards_pass_equals_reference(seed, leak):
    ref, port, pspec = _pair(ALTAIR, 600, seed, leak)
    assert ref_kernel.run_inactivity_and_rewards(ref, ALTAIR, RefAltairContext(ref, ALTAIR))
    before = dict(cuda_build.LAUNCHES)
    assert epoch_kernel.run_inactivity_and_rewards(port, pspec, _AltairContext(port, pspec),
                                                   device="cpu")
    assert cuda_build.LAUNCHES == before  # the plain version launches nothing
    assert list(port.inactivity_scores) == list(ref.inactivity_scores)
    assert list(port.balances) == list(ref.balances)
    assert epoch_kernel.LAST_EPOCH_STATS["validators"] == 600


def test_envelope_returns_false_in_both_with_no_launch():
    ref, port, pspec = _pair(ALTAIR, 16, 0, leak=True)
    ref.inactivity_scores[3] = port.inactivity_scores[3] = 2**60  # eff * score overflows
    balances = list(port.balances)
    before = dict(cuda_build.LAUNCHES)
    assert not ref_kernel.run_inactivity_and_rewards(ref, ALTAIR, RefAltairContext(ref, ALTAIR))
    assert not epoch_kernel.run_inactivity_and_rewards(port, pspec, _AltairContext(port, pspec),
                                                       device="cpu")
    assert cuda_build.LAUNCHES == before and list(port.balances) == balances


def test_edge_batch_plain_matches_spec_formulas():
    """The plain version on an edge batch against the spec's integer
    formulas lane by lane: zero effective balance, scores at the
    envelope's edge, balances driven below zero, the head flag's reward
    without a penalty, a leak and none."""
    inc = 10**9
    eff = np.array([0, 32 * inc, 32 * inc, 17 * inc, 32 * inc, inc], np.int64)
    part = np.array([7, 0, 4, 2, 7, 5], np.uint8)
    scores = np.array([0, 2**62 // (32 * inc) - 5, 3, 0, 1, 9], np.int64)
    bal = np.array([0, 1, 5, 40 * inc, 32 * inc, 0], np.int64)
    active = np.array([1, 1, 1, 1, 1, 0], bool)
    slashed = np.array([0, 0, 0, 1, 0, 1], bool)
    eligible = np.array([1, 1, 1, 1, 1, 1], bool)
    for leak in (0, 1):
        params = (357, inc, 114, leak, 4, 16, 4 * 3 * 2**24)
        got = epoch_kernel.rewards(*(torch.from_numpy(a) for a in (
            eff, part, scores, bal, active, slashed, eligible)), params)
        want_b, want_s = [], []
        unsl = active & ~slashed
        sums = [int(eff[unsl & ((part >> f) & 1 == 1)].sum()) for f in range(3)]
        for i in range(len(eff)):
            base = int(eff[i]) // inc * 357
            tgt = bool(unsl[i] and (part[i] >> 1) & 1)
            s = int(scores[i])
            s = s - min(1, s) if tgt else s + 4
            if not leak:
                s -= min(16, s)
            r = p = 0
            for f, w in enumerate((14, 26, 14)):
                inf = bool(unsl[i] and (part[i] >> f) & 1)
                if inf and not leak:
                    r += base * w * (max(inc, sums[f]) // inc) // (114 * 64)
                elif not inf and f != 2:
                    p += base * w // 64
            if not tgt:
                p += int(eff[i]) * s // params[6]
            want_b.append(max(0, int(bal[i]) + r - p))
            want_s.append(s)
        assert got[0].tolist() == want_b and got[1].tolist() == want_s, leak


def _boundary_states(spec, n, slot, rnd):
    state = Harness(spec, n).state
    state.slot = slot
    for i in range(len(state.validators)):
        state.balances[i] += rnd.randrange(0, 3 * 10**9)
        if spec.fork_name_at_epoch(spec.slot_to_epoch(slot)) != "phase0":
            state.previous_epoch_participation[i] = rnd.randrange(0, 8)
            state.current_epoch_participation[i] = rnd.randrange(0, 8)
            state.inactivity_scores[i] = rnd.randrange(0, 50)
    return state


BOUNDARIES = {
    # name: (spec, validators, start slot, end slot)
    "altair": (ALTAIR, 16, 6 * 8 + 5, 7 * 8 + 1),
    "phase0": (minimal_spec(), 16, 5 * 8 + 6, 6 * 8 + 1),
    "altair_upgrade": (minimal_spec(ALTAIR_FORK_EPOCH=2), 16, 8 + 7, 2 * 8 + 1),
    "sync_rotation": (ALTAIR, 16, 7 * 8 + 6, 8 * 8 + 1),
}


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_process_slots_state_roots_equal_reference(name):
    spec, n, start, end = BOUNDARIES[name]
    ref = _boundary_states(spec, n, start, random.Random(5))
    fork = spec.fork_name_at_epoch(spec.slot_to_epoch(start))
    pspec = spec_from_reference_yaml(spec_to_config_yaml(spec))
    port = state_from_ssz(type(ref).encode(ref), pspec, fork)
    pre_next = type(port).encode(port)
    ref_out = ref_process_slots(ref, end, spec)
    port_out = process_slots(port, end, pspec, device="cpu")
    assert type(port_out).__name__ == type(ref_out).__name__
    assert type(port_out).hash_tree_root(port_out) == type(ref_out).hash_tree_root(ref_out)
    assert type(port_out).encode(port_out) == type(ref_out).encode(ref_out)
    if name == "sync_rotation":  # the old next committee became the current one
        old = state_from_ssz(pre_next, pspec, fork).next_sync_committee
        assert type(old).encode(port_out.current_sync_committee) == type(old).encode(old)


@pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])
def test_process_epoch_on_a_mainnet_registry_equals_reference(leak):
    """`testing.epoch_state` (the chip run's 1 M-validator state, here at
    600) through a whole mainnet-spec epoch in both packages: pending
    activations, exits, slashings at the vector's midpoint, hysteresis."""
    spec = mainnet_spec(ALTAIR_FORK_EPOCH=0)
    pspec = spec_from_reference_yaml(spec_to_config_yaml(spec))
    port = T.epoch_state(pspec, 600, 1000, seed=4, leak=leak)
    ref = ref_types_for(spec).state_classes["altair"].decode(type(port).encode(port))
    ref_process_epoch(ref, spec)
    process_epoch(port, pspec, device="cpu")
    assert type(port).encode(port) == type(ref).encode(ref)
    assert epoch_kernel.LAST_EPOCH_STATS["validators"] == 600


def test_epoch_state_refuses_a_sync_rotation():
    pspec = spec_from_reference_yaml(spec_to_config_yaml(mainnet_spec(ALTAIR_FORK_EPOCH=0)))
    with pytest.raises(ValueError, match="rotates the sync committees"):
        T.epoch_state(pspec, 8, 255)


# ---------------------------------------- the kernel's division, modelled

# the divisors the kernel divides by: the increment, the inactivity
# denominator and the reward denominator, this last formed with int64 wrap
# (active_increments * 64: 2**57 wraps to INT64_MIN, 2**57 + 5 below 0,
# 2**58 + 3 to 192, 2**63 - 1 to -64)
DIVISORS = [1, 2, 3, 63, 64, 65, 10**9, 2**31 - 1, 2**31 + 1, 2**62, 2**63 - 1] + [
    epoch_kernel.reward_denominator(a) for a in (1, 114, 2**57, 2**57 + 5, 2**58 + 3, 2**63 - 1)]
SEEDED_DIVIDENDS = [int(x) for x in np.random.default_rng(15).integers(
    -2**63, 2**63 - 1, 48, dtype=np.int64, endpoint=True)]


@pytest.mark.parametrize("d", DIVISORS)
def test_divisor_magic_floors_like_int64(d):
    """The host's magic and the kernel's multiply-high with its floor
    correction (`floordiv_magic`, the quotient asserted exact) against
    Python's and torch's `//`: 0, +-1, +-(|d| - 1), +-|d|, +-(|d| + 1)
    (wrapped into int64), INT64_MIN, INT64_MAX and seeded int64 values."""
    magic = epoch_kernel.divisor_magic(d)
    v = abs(d)
    dividends = [0, 1, -1, epoch_kernel.INT64_MIN, -epoch_kernel.INT64_MIN - 1] + [
        epoch_kernel.wrap64(s * k) for k in (v - 1, v, v + 1) for s in (1, -1)] + SEEDED_DIVIDENDS
    got = [epoch_kernel.floordiv_magic(a, magic) for a in dividends]
    assert got == [a // d for a in dividends]
    assert got == (torch.tensor(dividends, dtype=torch.int64) // d).tolist()


def test_kernel_params_carry_the_magic_words():
    params = (357, 10**9, 2**57 + 5, 0, 4, 16, 4 * 3 * 2**24)
    words = epoch_kernel.kernel_params(params)
    assert len(words) == 16 and words[:7] == list(params)
    rd = epoch_kernel.reward_denominator(2**57 + 5)
    for k, d in enumerate((10**9, rd, 4 * 3 * 2**24)):
        m, v, shifts = words[7 + 3 * k: 10 + 3 * k]
        want = epoch_kernel.divisor_magic(d)
        assert (m & epoch_kernel.U64, v & epoch_kernel.U64) == want[:2]
        assert (shifts & 0xff, shifts >> 8 & 0xff, shifts >> 16) == want[2:]
    for bad in ((357, 0, 1, 0, 4, 16, 1), (357, 1, 2**58, 0, 4, 16, 1), (357, 1, 1, 0, 4, 16, -3)):
        with pytest.raises(ValueError):
            epoch_kernel.kernel_params(bad)


def test_plain_pass_wraps_like_int64():
    """rewards_plain on lanes whose products wrap, with a reward
    denominator that wraps below zero, against the spec's formulas lane
    by lane with every product, sum and quotient taken as int64."""
    w = epoch_kernel.wrap64
    rng = np.random.default_rng(16)
    n = 24
    eff = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    part = rng.integers(0, 256, n).astype(np.uint8)
    scores = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    bal = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    active, slashed, eligible = (rng.random((3, n)) < np.array([[0.7], [0.2], [0.8]]))
    for leak in (0, 1):
        params = (2**40 + 7, 3, 2**57 + 5, leak, 2**62, 3, 65)
        got = epoch_kernel.rewards(*(torch.from_numpy(a) for a in (
            eff, part, scores, bal, active, slashed, eligible)), params)
        rd = w((2**57 + 5) * 64)
        unsl = active & ~slashed
        sums = [w(sum(int(e) for e, u, p in zip(eff, unsl, part) if u and (p >> f) & 1))
                for f in range(3)]
        want_b, want_s = [], []
        for i in range(n):
            e, s0 = int(eff[i]), int(scores[i])
            base = w(e // 3 * params[0])
            tgt = bool(unsl[i] and (part[i] >> 1) & 1)
            s = w(s0 - min(1, s0)) if tgt else w(s0 + params[4])
            if not leak:
                s = w(s - min(3, s))
            if not eligible[i]:
                s = s0
            r = p = 0
            for f, wt in enumerate((14, 26, 14)):
                inf = bool(unsl[i] and (part[i] >> f) & 1)
                if eligible[i] and inf and not leak:
                    r = w(r + w(w(base * wt) * (max(3, sums[f]) // 3)) // rd)
                if f != 2 and eligible[i] and not inf:
                    p = w(p + w(base * wt) // 64)
            if eligible[i] and not tgt:
                p = w(p + w(e * s) // 65)
            want_b.append(max(0, w(w(int(bal[i]) + r) - p)))
            want_s.append(s)
        assert got[0].tolist() == want_b and got[1].tolist() == want_s, leak


# the reward denominators active_increments * 64 that wrap in int64: below
# zero, to 192, to -64
WRAPPING_ACTIVE = [2**57 + 5, 2**58 + 3, 2**63 - 1]


@pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])
@pytest.mark.parametrize("active_increments", WRAPPING_ACTIVE)
def test_plain_pass_wraps_like_the_reference_jitted_pass(active_increments, leak):
    """rewards_plain against the reference's jitted `_kernel` on 600 seeded
    lanes whose products, sums and reward denominator wrap in int64: the
    shape and dtypes of test_rewards_pass_equals_reference's call, so its
    compiled pass serves."""
    import jax

    rng = np.random.default_rng(17)
    n = 600
    eff, scores, bal = (rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
                        for _ in range(3))
    part = rng.integers(0, 256, n).astype(np.uint8)
    active, slashed, eligible = (rng.random((3, n)) < np.array([[0.7], [0.2], [0.8]]))
    params = (2**40 + 7, 3, active_increments, int(leak), 2**62, 3, 65)
    got = epoch_kernel.rewards(*(torch.from_numpy(a) for a in (
        eff, part, scores, bal, active, slashed, eligible)), params)
    with ref_kernel._x64_context(jax)(True):
        want = ref_kernel._get_jitted()(
            eff, part.astype(np.int64), scores, bal, active, slashed, eligible,
            np.int64(params[0]), np.int64(params[1]), np.int64(params[2]), np.bool_(leak),
            np.int64(params[4]), np.int64(params[5]), np.int64(params[6]))
        want = [np.asarray(w) for w in want]
    assert got[0].tolist() == want[0].tolist() and got[1].tolist() == want[1].tolist()
