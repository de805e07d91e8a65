"""The state transition: slot, epoch and block processing, with the altair
rewards pass on the card (`epoch_kernel.py`) and every block signature
through the port's `bls` (`per_block.py`)."""

from lighthouse_tpu_torch.state_processing.per_slot import (  # noqa: F401
    per_slot_processing,
    process_slots,
)
from lighthouse_tpu_torch.state_processing.per_block import (  # noqa: F401
    BlockSignatureStrategy,
    per_block_processing,
)
from lighthouse_tpu_torch.state_processing.genesis import (  # noqa: F401
    interop_genesis_state,
)
from lighthouse_tpu_torch.state_processing.per_epoch import process_epoch  # noqa: F401
