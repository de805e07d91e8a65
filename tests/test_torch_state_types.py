"""The port's own SSZ and state types (lighthouse_tpu_torch.ssz, .types)
against the JAX package's: a harness state carried as SSZ bytes decodes
into the port's container with the same bytes and the same roots, and a
spec survives the config.yaml carry."""

import dataclasses
import hashlib

import pytest

from lighthouse_tpu.harness import Harness
from lighthouse_tpu.types.spec import mainnet_spec, minimal_spec, spec_to_config_yaml
from lighthouse_tpu_torch.native import hashtree
from lighthouse_tpu_torch.ssz import hashing
from lighthouse_tpu_torch.ssz.cached_hash import cached_state_root
from lighthouse_tpu_torch.types import carry
from lighthouse_tpu_torch.types.containers import types_for

SPECS = {
    "minimal": lambda: minimal_spec(ALTAIR_FORK_EPOCH=0),
    "mainnet": lambda: mainnet_spec(ALTAIR_FORK_EPOCH=0),
    "minimal_phase0": minimal_spec,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_harness_state_carries_with_equal_bytes_and_roots(name):
    spec = SPECS[name]()
    state = Harness(spec, 16).state
    fork = spec.fork_name_at_epoch(0)
    data = type(state).encode(state)
    pspec = carry.spec_from_reference_yaml(spec_to_config_yaml(spec))
    port = carry.state_from_ssz(data, pspec, fork)
    assert type(port) is types_for(pspec).state_classes[fork]
    assert type(port).encode(port) == data
    root = type(state).hash_tree_root(state)
    assert type(port).hash_tree_root(port) == root
    assert cached_state_root(port) == root  # the incremental root too
    port.balances[3] += 1
    state.balances[3] += 1
    assert cached_state_root(port) == type(state).hash_tree_root(state) != root


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_survives_the_yaml_carry(name):
    spec = SPECS[name]()
    pspec = carry.spec_from_reference_yaml(spec_to_config_yaml(spec))
    assert {f.name: getattr(pspec, f.name) for f in dataclasses.fields(pspec)} == {
        f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    over = carry.spec_from_reference_yaml(spec_to_config_yaml(spec), ALTAIR_FORK_EPOCH=7)
    assert over.ALTAIR_FORK_EPOCH == 7 and over.SLOTS_PER_EPOCH == spec.SLOTS_PER_EPOCH


def test_state_from_ssz_refuses_an_unknown_fork():
    spec = carry.spec_from_reference_yaml(spec_to_config_yaml(minimal_spec()))
    with pytest.raises(ValueError, match="unknown fork"):
        carry.state_from_ssz(b"", spec, "capella")


def test_native_hash_pairs_equals_hashlib():
    data = bytes(range(256)) * 3
    want = b"".join(hashlib.sha256(data[i:i + 64]).digest() for i in range(0, len(data), 64))
    assert hashtree.hash_pairs(data) == want
    assert hashing.hash32_many([data[i:i + 64] for i in range(0, len(data), 64)]) == [
        want[i:i + 32] for i in range(0, len(want), 32)]
