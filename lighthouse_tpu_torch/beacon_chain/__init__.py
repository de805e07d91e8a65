"""The chain runtime: the port of `lighthouse_tpu/beacon_chain/`."""

from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain  # noqa: F401
