"""The deposit tree of the eth1 plane; the eth1 service waits for the
port's `eth1/` (ROADMAP Queue 1 item 8)."""

from lighthouse_tpu_torch.eth1.deposit_tree import DepositTree  # noqa: F401
