"""Attestation subnet plane: committee→subnet mapping + duty-driven
subscriptions.

The port of `lighthouse_tpu/network/subnet_service.py`.

Role of the reference's attestation subnet service
(beacon_node/network/src/subnet_service/attestation_subnets.rs:1-50 +
consensus/types/src/subnet_id.rs): gossip load shards across
ATTESTATION_SUBNET_COUNT (64) `beacon_attestation_{id}` topics. A node
keeps a few LONG-LIVED subnets (its share of the backbone, advertised via
discovery so peers can find subnet coverage) and joins others JUST IN TIME
for attestation duties, unsubscribing when the duty slot passes.
"""

SUBNETS_PER_NODE = 2  # long-lived backbone share (p2p spec)
# keep a duty subscription this many slots past its duty (aggregates of
# the duty slot still arrive during the next slot)
DUTY_LINGER_SLOTS = 1


def compute_subnet(
    spec, slot: int, committee_index: int, committees_per_slot: int
) -> int:
    """subnet_id.rs compute_subnet_for_attestation: committees since the
    epoch start, offset by the committee index, mod the subnet count."""
    slots_since_epoch_start = slot % spec.SLOTS_PER_EPOCH
    committees_since_epoch_start = (
        committees_per_slot * slots_since_epoch_start
    )
    return (
        committees_since_epoch_start + committee_index
    ) % spec.ATTESTATION_SUBNET_COUNT


def subnet_topic_name(subnet_id: int) -> str:
    return f"beacon_attestation_{subnet_id}"


class AttestationSubnetService:
    """Tracks which attestation subnets this node is subscribed to and
    why (long-lived backbone vs duty), driving the hub's
    subscribe/unsubscribe as duties come and go."""

    def __init__(self, spec, node_id: str, subscribe, unsubscribe):
        """`subscribe`/`unsubscribe` take a bare topic NAME (e.g.
        "beacon_attestation_7"); the node curries its fork digest in."""
        self.spec = spec
        self.node_id = node_id
        self._subscribe = subscribe
        self._unsubscribe = unsubscribe
        # subnet id -> expiry slot (duty subscriptions only)
        self._duty_expiry: dict[int, int] = {}
        # deterministic long-lived backbone subnets from the node id
        # (the reference derives them from the node's ENR/peer id so the
        # backbone is stable across restarts)
        import hashlib

        seed = hashlib.sha256(node_id.encode()).digest()
        count = spec.ATTESTATION_SUBNET_COUNT
        self.long_lived = []
        i = 0
        while len(self.long_lived) < min(SUBNETS_PER_NODE, count):
            sub = int.from_bytes(seed[4 * i : 4 * i + 4], "little") % count
            if sub not in self.long_lived:
                self.long_lived.append(sub)
            i += 1
        for sub in self.long_lived:
            self._subscribe(subnet_topic_name(sub))

    # ------------------------------------------------------------- duties

    def subscribe_for_duty(
        self, slot: int, committee_index: int, committees_per_slot: int
    ) -> int:
        """Join the subnet carrying `committee_index`'s attestations at
        `slot` (attestation_subnets.rs validator_subscriptions). Returns
        the subnet id."""
        sub = compute_subnet(
            self.spec, slot, committee_index, committees_per_slot
        )
        expiry = slot + DUTY_LINGER_SLOTS
        prev = self._duty_expiry.get(sub)
        if prev is None and sub not in self.long_lived:
            self._subscribe(subnet_topic_name(sub))
        if prev is None or expiry > prev:
            self._duty_expiry[sub] = expiry
        return sub

    def on_slot(self, slot: int):
        """Drop duty subscriptions whose window passed (long-lived
        backbone subnets are never dropped)."""
        expired = [
            sub for sub, exp in self._duty_expiry.items() if exp < slot
        ]
        for sub in expired:
            del self._duty_expiry[sub]
            if sub not in self.long_lived:
                self._unsubscribe(subnet_topic_name(sub))

    @property
    def active_subnets(self) -> set:
        return set(self.long_lived) | set(self._duty_expiry)
