"""Fork choice: the port of `lighthouse_tpu/fork_choice/` (the proto-array
DAG and the spec's on_block / on_attestation / get_head over it)."""

from lighthouse_tpu_torch.fork_choice.proto_array import ProtoArray  # noqa: F401
from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice  # noqa: F401
