"""Light-client serving plane: sync-committee update production.

The port of `lighthouse_tpu/light_client/`: `producer.LightClientUpdateProducer`
rides `chain.import_hooks`, maintaining the best update per sync-committee
period, the current finality/optimistic updates, and bootstrap documents for
recent finalized roots -- proofs extracted through ssz/gindex against the
incremental tree-hash cache. The client half (`store.LightClientStore`) is
not ported yet (ROADMAP Queue 1).
"""

from lighthouse_tpu_torch.light_client.producer import (  # noqa: F401
    LightClientUpdateProducer,
)
