from lighthouse_tpu_torch.types.spec import (  # noqa: F401
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    GENESIS_SLOT,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Spec,
    mainnet_spec,
    minimal_spec,
)
from lighthouse_tpu_torch.types.containers import types_for  # noqa: F401
from lighthouse_tpu_torch.types.helpers import (  # noqa: F401
    compute_domain,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
)
