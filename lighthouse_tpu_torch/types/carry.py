"""Carrying a spec and a state into the port's own types.

The JAX package and the port each have their own `Spec` and SSZ
containers; what passes between them is text and bytes, never objects:

* `spec_from_reference_yaml(text, **overrides)` builds the port's `Spec`
  from a consensus config.yaml, as the JAX package's
  `spec_to_config_yaml` writes it (every field, so nothing is left to the
  preset), with `overrides` applied last;
* `state_from_ssz(data, spec, fork)` decodes a BeaconState's SSZ bytes
  into the port's container of that fork.

Both work on any config.yaml and any SSZ state, so a node can also start
the port from a network's config and a checkpoint state.
"""

from dataclasses import replace

from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.spec import Spec, spec_from_config_yaml


def spec_from_reference_yaml(text: str, **overrides) -> Spec:
    spec = spec_from_config_yaml(text)
    return replace(spec, **overrides) if overrides else spec


def state_from_ssz(data: bytes, spec: Spec, fork: str):
    classes = types_for(spec).state_classes
    if fork not in classes:
        raise ValueError(f"unknown fork {fork!r}: expected one of {sorted(classes)}")
    return classes[fork].decode(bytes(data))
