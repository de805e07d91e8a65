"""The state transition's slot and epoch processing, with the altair
rewards pass on the card (`epoch_kernel.py`)."""

from lighthouse_tpu_torch.state_processing.per_slot import (  # noqa: F401
    per_slot_processing,
    process_slots,
)
from lighthouse_tpu_torch.state_processing.per_epoch import process_epoch  # noqa: F401
