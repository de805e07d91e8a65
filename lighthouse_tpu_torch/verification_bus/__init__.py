from lighthouse_tpu_torch.verification_bus.bus import (  # noqa: F401
    DEFAULT_CLASS_BUDGETS,
    DEFAULT_FILL_TARGET,
    DEFAULT_GPU_HOLD_MS,
    VerificationBus,
)
from lighthouse_tpu_torch.verification_bus.wall_model import (  # noqa: F401
    PredictedWallModel,
)
