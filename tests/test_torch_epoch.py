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
