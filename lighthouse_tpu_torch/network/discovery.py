"""Peer discovery: bootstrap registry + peer records.

The port of `lighthouse_tpu/network/discovery.py`.

Role of the reference's discv5 integration (lighthouse_network/src/
discovery/mod.rs, boot_node crate): nodes register ENR-like records with a
bootstrap registry and query it for peers matching subnet predicates. The
transport-level Kademlia DHT of discv5 is out of scope for the in-process
topology; this preserves the discovery SURFACE (records, queries, subnet
predicates, liveness) so node wiring and tests exercise the same flow.
"""

import time
from dataclasses import dataclass, field


@dataclass
class PeerRecord:
    node_id: str
    seq: int = 1
    attnets: list = field(default_factory=lambda: [False] * 64)
    last_seen: float = field(default_factory=time.monotonic)

    def matches_subnets(self, subnets) -> bool:
        return any(self.attnets[s] for s in subnets)


class BootstrapRegistry:
    """The boot node: holds peer records, answers queries."""

    def __init__(self, liveness_timeout: float = 300.0):
        self.records: dict[str, PeerRecord] = {}
        self.liveness_timeout = liveness_timeout

    def register(self, record: PeerRecord):
        existing = self.records.get(record.node_id)
        if existing is None or record.seq > existing.seq:
            record.last_seen = time.monotonic()
            self.records[record.node_id] = record

    def refresh(self, node_id: str):
        rec = self.records.get(node_id)
        if rec:
            rec.last_seen = time.monotonic()

    def _alive(self):
        cutoff = time.monotonic() - self.liveness_timeout
        return [r for r in self.records.values() if r.last_seen >= cutoff]

    def find_peers(self, exclude: str, limit: int = 16):
        return [r for r in self._alive() if r.node_id != exclude][:limit]

    def find_subnet_peers(self, subnets, exclude: str, limit: int = 16):
        """Subnet-predicate peer search (discovery/mod.rs subnet
        queries)."""
        return [
            r
            for r in self._alive()
            if r.node_id != exclude and r.matches_subnets(subnets)
        ][:limit]
