from lighthouse_tpu_torch.network.beacon_processor import (  # noqa: F401
    BeaconProcessor,
    WorkItem,
)
from lighthouse_tpu_torch.network.gossip import GossipHub  # noqa: F401
