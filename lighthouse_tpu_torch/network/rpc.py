"""Req/resp RPC: Status, Ping, Metadata, Goodbye, BlocksByRange/ByRoot,
BlobSidecarsByRange/ByRoot.

The port of `lighthouse_tpu/network/rpc.py`.

Role of the reference's rpc stack (lighthouse_network/src/rpc/: methods,
protocol negotiation, ssz_snappy codec, per-protocol rate limiting). SSZ
payloads over an abstract peer channel (in-process here; the framing layer
is transport-agnostic), with a token-bucket rate limiter per (peer,
method) mirroring rpc/rate_limiter.rs.

The req/resp surface is an adversarial boundary: every method is
rate-limited BEFORE any store work runs, request sizes are clamped to the
protocol maxima, and the `lighthouse_tpu_rpc_requests_total` family
records every served/rate-limited/errored request so an abusive peer is
visible on the scrape before it is visible in the logs.
"""

import functools
import time
from dataclasses import dataclass

from lighthouse_tpu_torch import ssz
from lighthouse_tpu_torch.common.metrics import REGISTRY


class StatusMessage(ssz.Container):
    fork_digest: ssz.bytes4
    finalized_root: ssz.bytes32
    finalized_epoch: ssz.uint64
    head_root: ssz.bytes32
    head_slot: ssz.uint64


class Ping(ssz.Container):
    data: ssz.uint64


class MetaData(ssz.Container):
    seq_number: ssz.uint64
    attnets: ssz.Bitvector(64)


class Goodbye(ssz.Container):
    reason: ssz.uint64


class BlocksByRangeRequest(ssz.Container):
    start_slot: ssz.uint64
    count: ssz.uint64
    step: ssz.uint64


MAX_REQUEST_BLOCKS = 1024
# deneb p2p: MAX_REQUEST_BLOCKS_DENEB (128) * MAX_BLOBS_PER_BLOCK (6)
MAX_REQUEST_BLOB_SIDECARS = 768
# PeerDAS p2p: MAX_REQUEST_BLOCKS_DENEB (128) * NUMBER_OF_COLUMNS (128)
MAX_REQUEST_DATA_COLUMN_SIDECARS = 16384


class BlobIdentifier(ssz.Container):
    """(block_root, index) — the by-root request key for one sidecar
    (deneb p2p BlobIdentifier). A wire-local twin of the spec-bound
    container in types/containers.py: request framing must not depend
    on a Spec instance."""

    block_root: ssz.bytes32
    index: ssz.uint64


class DataColumnIdentifier(ssz.Container):
    """(block_root, index) — the by-root request key for one COLUMN
    sidecar (PeerDAS p2p DataColumnIdentifier), wire-local like
    BlobIdentifier above."""

    block_root: ssz.bytes32
    index: ssz.uint64


class BlobSidecarsByRootRequest(ssz.Container):
    identifiers: ssz.List(BlobIdentifier, MAX_REQUEST_BLOB_SIDECARS)


class DataColumnSidecarsByRootRequest(ssz.Container):
    identifiers: ssz.List(
        DataColumnIdentifier, MAX_REQUEST_DATA_COLUMN_SIDECARS
    )


class BlobSidecarsByRangeRequest(ssz.Container):
    start_slot: ssz.uint64
    count: ssz.uint64


# token-bucket quotas per method: (tokens, per_seconds)
QUOTAS = {
    "status": (5, 15),
    "ping": (2, 10),
    "metadata": (2, 5),
    "goodbye": (1, 10),
    "blocks_by_range": (1024, 10),
    "blocks_by_root": (128, 10),
    "blob_sidecars_by_range": (MAX_REQUEST_BLOB_SIDECARS, 10),
    "blob_sidecars_by_root": (MAX_REQUEST_BLOB_SIDECARS, 10),
    "data_column_sidecars_by_root": (MAX_REQUEST_DATA_COLUMN_SIDECARS, 10),
}

_RPC_REQUESTS = REGISTRY.counter_vec(
    "lighthouse_tpu_rpc_requests_total",
    "req/resp requests, by method and outcome (ok|rate_limited|error)",
    ("method", "outcome"),
)
_RPC_SIDECARS_SERVED = REGISTRY.counter(
    "lighthouse_tpu_rpc_blob_sidecars_served_total",
    "blob sidecars served over the by_range/by_root req/resp methods",
)
_RPC_COLUMNS_SERVED = REGISTRY.counter(
    "lighthouse_tpu_rpc_data_columns_served_total",
    "data-column sidecars served over the by_root req/resp method",
)


class RateLimitExceeded(Exception):
    pass


class _Bucket:
    def __init__(self, tokens, per_seconds):
        self.capacity = tokens
        self.refill = tokens / per_seconds
        self.tokens = float(tokens)
        self.last = time.monotonic()

    def take(self, n=1.0):
        now = time.monotonic()
        self.tokens = min(
            self.capacity, self.tokens + (now - self.last) * self.refill
        )
        self.last = now
        if self.tokens < n:
            raise RateLimitExceeded
        self.tokens -= n


@dataclass
class RpcError(Exception):
    code: int
    message: str


def _counted(method_name: str):
    """Record the request outcome AFTER the handler runs: ok only when
    it actually served, error when it raised (rate_limited is recorded
    at the bucket, before any work)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, peer_id, *args, **kwargs):
            try:
                out = fn(self, peer_id, *args, **kwargs)
            except RateLimitExceeded:
                raise
            except Exception:
                _RPC_REQUESTS.labels(method_name, "error").inc()
                raise
            _RPC_REQUESTS.labels(method_name, "ok").inc()
            return out

        return wrapper

    return deco


class RpcServer:
    """Per-node RPC endpoint serving the standard methods from a chain."""

    def __init__(self, chain, node_id: str, fork_digest: bytes):
        self.chain = chain
        self.node_id = node_id
        self.fork_digest = fork_digest
        self.seq_number = 0
        self._buckets: dict[tuple, _Bucket] = {}
        # goodbye hook: the node wires this to SyncManager.remove_peer so
        # a cleanly-disconnecting peer leaves without any score penalty
        self.on_goodbye = None

    def _limit(self, peer_id: str, method: str, n=1.0):
        key = (peer_id, method)
        if key not in self._buckets:
            self._buckets[key] = _Bucket(*QUOTAS[method])
        try:
            self._buckets[key].take(n)
        except RateLimitExceeded:
            _RPC_REQUESTS.labels(method, "rate_limited").inc()
            raise

    # ------------------------------------------------------------ methods

    @_counted("status")
    def status(self, peer_id: str) -> StatusMessage:
        self._limit(peer_id, "status")
        chain = self.chain
        head = chain.head_state
        fin = head.finalized_checkpoint
        return StatusMessage(
            fork_digest=self.fork_digest,
            finalized_root=bytes(fin.root)
            if fin.epoch
            else chain.genesis_root,
            finalized_epoch=fin.epoch,
            head_root=chain.head_root,
            head_slot=head.slot,
        )

    @_counted("ping")
    def ping(self, peer_id: str, data: int) -> int:
        self._limit(peer_id, "ping")
        return self.seq_number

    @_counted("metadata")
    def metadata(self, peer_id: str) -> MetaData:
        self._limit(peer_id, "metadata")
        return MetaData(seq_number=self.seq_number, attnets=[True] * 64)

    @_counted("goodbye")
    def goodbye(self, peer_id: str, reason: int = 0):
        """Clean disconnect (rpc GoodbyeReason): the peer announced it is
        leaving, so drop it from the serving side's sync view with NO
        score penalty — saying goodbye is polite, not misbehavior."""
        self._limit(peer_id, "goodbye")
        if self.on_goodbye is not None:
            self.on_goodbye(peer_id, int(reason))

    @_counted("blocks_by_range")
    def blocks_by_range(self, peer_id: str, req: BlocksByRangeRequest):
        count = min(req.count, MAX_REQUEST_BLOCKS)
        self._limit(peer_id, "blocks_by_range", float(count))
        if req.step != 1:
            raise RpcError(1, "step != 1 unsupported")
        out = []
        for slot in range(req.start_slot, req.start_slot + count):
            root = self.chain.store.get_canonical_block_root(slot)
            if root is None:
                continue
            block = self.chain.store.get_block(root)
            if block is not None:
                out.append(block)
        return out

    @_counted("blocks_by_root")
    def blocks_by_root(self, peer_id: str, roots):
        self._limit(peer_id, "blocks_by_root", float(len(roots)))
        out = []
        for root in roots:
            block = self.chain.store.get_block(bytes(root))
            if block is not None:
                out.append(block)
        return out

    @_counted("blob_sidecars_by_root")
    def blob_sidecars_by_root(self, peer_id: str, identifiers):
        """Serve stored sidecars for explicit (block_root, index) keys —
        the unknown-parent recovery path. Requests beyond
        MAX_REQUEST_BLOB_SIDECARS identifiers are clamped, and the
        bucket is charged per identifier BEFORE any store read."""
        identifiers = list(identifiers)[:MAX_REQUEST_BLOB_SIDECARS]
        self._limit(
            peer_id, "blob_sidecars_by_root", float(len(identifiers) or 1)
        )
        out = []
        wanted: dict[bytes, set] = {}
        for ident in identifiers:
            wanted.setdefault(bytes(ident.block_root), set()).add(
                int(ident.index)
            )
        for root, indices in wanted.items():
            for sc in self.chain.store.get_blob_sidecars(root):
                if int(sc.index) in indices:
                    out.append(sc)
        _RPC_SIDECARS_SERVED.inc(len(out))
        return out

    @_counted("data_column_sidecars_by_root")
    def data_column_sidecars_by_root(self, peer_id: str, identifiers):
        """Serve verified (or reconstructed) column sidecars for
        explicit (block_root, index) keys — the column-mode twin of
        blob_sidecars_by_root behind unknown-parent recovery and range
        sync. A column node holds every released block's FULL column
        set until finalization prunes it (the checker reconstructs the
        missing half at release), so any node that imported the block
        can serve any index. Blob-mode nodes hold no columns and
        answer empty."""
        identifiers = list(identifiers)[:MAX_REQUEST_DATA_COLUMN_SIDECARS]
        self._limit(
            peer_id,
            "data_column_sidecars_by_root",
            float(len(identifiers) or 1),
        )
        columns_for = getattr(self.chain.da_checker, "columns_for", None)
        if columns_for is None:
            return []
        wanted: dict[bytes, set] = {}
        for ident in identifiers:
            wanted.setdefault(bytes(ident.block_root), set()).add(
                int(ident.index)
            )
        out = []
        for root, indices in wanted.items():
            for sc in columns_for(root):
                if int(sc.index) in indices:
                    out.append(sc)
        _RPC_COLUMNS_SERVED.inc(len(out))
        return out

    @_counted("blob_sidecars_by_range")
    def blob_sidecars_by_range(
        self, peer_id: str, req: BlobSidecarsByRangeRequest
    ):
        """Serve canonical sidecars for a slot range (range-sync DA
        companion to blocks_by_range), capped at
        MAX_REQUEST_BLOB_SIDECARS sidecars total."""
        # charge for what a slot can actually CARRY (MAX_BLOBS_PER_BLOCK
        # sidecars), not one token per slot — a per-slot charge would be
        # a 6x bandwidth amplifier against the bucket. The slot clamp
        # keeps the worst-case charge exactly at the bucket's capacity
        # (768 / 6 = 128 slots on mainnet params = the deneb
        # MAX_REQUEST_BLOCKS_DENEB), so a maximal request is serveable
        # on a fresh bucket and never truncates mid-range.
        max_blobs = self.chain.store.spec.MAX_BLOBS_PER_BLOCK
        count = min(req.count, MAX_REQUEST_BLOB_SIDECARS // max_blobs)
        self._limit(
            peer_id, "blob_sidecars_by_range", float(count * max_blobs)
        )
        out = self.chain.store.get_blob_sidecars_by_range(
            int(req.start_slot), int(count), limit=MAX_REQUEST_BLOB_SIDECARS
        )
        _RPC_SIDECARS_SERVED.inc(len(out))
        return out
