"""Gossip plane: topic pub/sub with per-peer scoring, in-process transport.

The port of `lighthouse_tpu/network/gossip.py`.

Role of the reference's lighthouse_network gossipsub wrapper
(behaviour/mod.rs:148 composing gossipsub + peer manager): fork-versioned
topic strings, publish/subscribe fan-out, duplicate suppression by message
id, and peer scoring hooks that quarantine misbehaving peers
(peer_manager/ scoring). The transport here is in-process (the
testing/simulator topology — multiple nodes, one process); a socket
transport can implement the same `publish/deliver` surface.
"""

import hashlib
from collections import defaultdict

GOSSIP_MAX_SIZE = 10 * 1024 * 1024

# peer-score actions (peer_manager scoring semantics)
SCORE_INVALID_MESSAGE = -20.0
SCORE_DUPLICATE = -0.5
SCORE_VALID = 0.5
# req/resp misbehavior is scored through the same hub: an unresponsive
# or erroring peer costs a little (it may just be overloaded), a peer
# serving malformed/hash-chain-violating responses costs
# SCORE_INVALID_MESSAGE (it is provably lying)
SCORE_TIMEOUT = -1.0
BAN_THRESHOLD = -50.0


def topic(fork_digest: bytes, name: str) -> str:
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def blob_sidecar_topic_name(subnet_id: int) -> str:
    """`blob_sidecar_{subnet_id}` — the deneb p2p sidecar topics; a
    sidecar's subnet is its index modulo BLOB_SIDECAR_SUBNET_COUNT
    (compute_subnet_for_blob_sidecar)."""
    return f"blob_sidecar_{subnet_id}"


def compute_blob_subnet(index: int, subnet_count: int) -> int:
    return int(index) % max(int(subnet_count), 1)


def data_column_sidecar_topic_name(subnet_id: int) -> str:
    """`data_column_sidecar_{subnet_id}` — the PeerDAS column topics; a
    column's subnet is its index modulo DATA_COLUMN_SIDECAR_SUBNET_COUNT
    (compute_subnet_for_data_column_sidecar)."""
    return f"data_column_sidecar_{subnet_id}"


def compute_column_subnet(index: int, subnet_count: int) -> int:
    return int(index) % max(int(subnet_count), 1)


def message_id(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:20]


class Peer:
    def __init__(self, peer_id: str, deliver):
        self.peer_id = peer_id
        self.deliver = deliver  # callable(topic, data, from_peer)
        self.score = 0.0
        self.banned = False

    def apply_score(self, delta: float):
        self.score += delta
        if self.score <= BAN_THRESHOLD:
            self.banned = True


class GossipHub:
    """A broadcast domain connecting peers (nodes)."""

    def __init__(self):
        self.peers: dict[str, Peer] = {}
        self.subscriptions: dict[str, set] = defaultdict(set)
        self._seen: set[bytes] = set()

    def join(self, peer_id: str, deliver) -> Peer:
        peer = Peer(peer_id, deliver)
        self.peers[peer_id] = peer
        return peer

    def subscribe(self, peer_id: str, topic_str: str):
        self.subscriptions[topic_str].add(peer_id)

    def unsubscribe(self, peer_id: str, topic_str: str):
        self.subscriptions[topic_str].discard(peer_id)

    def publish(self, from_peer: str, topic_str: str, data: bytes):
        """Fan out to subscribers; drops duplicates and oversized frames,
        skips banned publishers."""
        src = self.peers.get(from_peer)
        if src is None or src.banned:
            return 0
        if len(data) > GOSSIP_MAX_SIZE:
            src.apply_score(SCORE_INVALID_MESSAGE)
            return 0
        mid = message_id(topic_str.encode() + data)
        if mid in self._seen:
            src.apply_score(SCORE_DUPLICATE)
            return 0
        self._seen.add(mid)
        delivered = 0
        for pid in list(self.subscriptions.get(topic_str, ())):
            if pid == from_peer:
                continue
            peer = self.peers.get(pid)
            if peer is None or peer.banned:
                continue
            peer.deliver(topic_str, data, from_peer)
            delivered += 1
        return delivered

    def report(self, peer_id: str, delta: float):
        """Application-level validation feedback -> peer score."""
        peer = self.peers.get(peer_id)
        if peer is not None:
            peer.apply_score(delta)

    def prune_seen(self, keep: int = 100_000):
        if len(self._seen) > keep:
            self._seen = set(list(self._seen)[-keep // 2 :])


# ----------------------------------------------------------- wire codecs


def encode_gossip(ssz_bytes: bytes) -> bytes:
    """Gossip payloads are raw-snappy-block compressed SSZ (the
    `/ssz_snappy` topic encoding, types/pubsub.rs)."""
    from lighthouse_tpu_torch.network.snappy_codec import compress_block

    return compress_block(ssz_bytes)


def decode_gossip(data: bytes, max_len: int = 10 * 1024 * 1024) -> bytes:
    from lighthouse_tpu_torch.network.snappy_codec import decompress_block

    return decompress_block(data, max_len)
