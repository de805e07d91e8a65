"""Deterministic fault injection for the req/resp plane.

The port of `lighthouse_tpu/network/fault_injection.py`.

Role of the reference's Antithesis / network-simulation fault campaigns
(the reference client is continuously fuzzed with dropped, delayed, and
corrupted network messages): wrap any RpcServer-shaped peer handle in a
`FaultyRpc` and, driven by a SEEDED RNG, drop, stall, truncate, corrupt,
duplicate, or rate-limit-exhaust its responses. Every decision comes off
`random.Random(seed)` in call order, so a failing chaos run replays
exactly from its seed — no real sleeping, no wall-clock dependence.

Fault semantics (what the sync client should observe):

  drop        empty response (the peer claims it has nothing)
  stall       RpcError(code=2, ...) — the socket layer's timeout shape
  truncate    only the first half of the response arrives
  corrupt     one element is rewritten: a block's signature or
              parent_root is flipped, a sidecar's blob is flipped —
              exercising the segment signature batch, the hash-chain
              validation, and the KZG settle path respectively
  duplicate   one element is repeated in place
  rate_limit  RateLimitExceeded — the peer claims the caller is over
              budget on every request
"""

import random

from lighthouse_tpu_torch.network.rpc import RateLimitExceeded, RpcError

FAULT_KINDS = (
    "drop",
    "stall",
    "truncate",
    "corrupt",
    "duplicate",
    "rate_limit",
)


def _reencode(obj):
    """A deep, independent copy via the SSZ wire (Container.copy() can
    share nested structure; a corrupted response must never mutate the
    serving store's objects)."""
    return type(obj).decode(obj.to_bytes())


def _flip(data: bytes, pos: int, mask: int = 0x01) -> bytes:
    out = bytearray(data)
    out[pos] ^= mask
    return bytes(out)


def corrupt_element(obj, rng: random.Random):
    """Rewrite one adversarial field of a response element."""
    c = _reencode(obj)
    if hasattr(c, "blob"):
        # sidecar: flip the low byte of one field element — still a
        # canonical field encoding, but the KZG proof no longer opens it
        blob = bytearray(bytes(c.blob))
        blob[rng.randrange(len(blob) // 32) * 32 + 31] ^= 0x01
        c.blob = bytes(blob)
        return c
    if hasattr(c, "message") and hasattr(c, "signature"):
        if rng.random() < 0.5:
            # signature flip: survives structural validation, fails the
            # segment's bulk signature batch
            c.signature = _flip(bytes(c.signature), 1)
        else:
            # parent-root flip: a hash-chain violation the client's
            # response validation must catch without any crypto
            c.message.parent_root = _flip(
                bytes(c.message.parent_root), 0
            )
        return c
    return c


class FaultyRpc:
    """RpcServer-shaped wrapper injecting seeded faults into responses.

    `fault_rate` is the per-call probability of injecting a fault;
    `kinds` restricts the fault mix (default: all). `injected` counts
    what actually fired, per kind — chaos tests assert against it so a
    quiet seed cannot silently test nothing.
    """

    def __init__(
        self,
        inner,
        seed: int = 0,
        fault_rate: float = 0.5,
        kinds=FAULT_KINDS,
        fault_status: bool = False,
    ):
        self.inner = inner
        self.rng = random.Random(seed)
        self.fault_rate = fault_rate
        self.kinds = tuple(kinds)
        self.fault_status = fault_status
        self.injected = {k: 0 for k in self.kinds}
        self.calls = 0

    def _pick_fault(self):
        if self.rng.random() >= self.fault_rate:
            return None
        kind = self.kinds[self.rng.randrange(len(self.kinds))]
        self.injected[kind] += 1
        return kind

    def _listy(self, method: str, call):
        """Apply one fault decision to a list-shaped response."""
        self.calls += 1
        kind = self._pick_fault()
        if kind == "stall":
            raise RpcError(2, f"injected stall on {method}")
        if kind == "rate_limit":
            raise RateLimitExceeded
        if kind == "drop":
            return []
        out = list(call())
        if kind is None or not out:
            return out
        if kind == "truncate":
            return out[: len(out) // 2]
        if kind == "duplicate":
            i = self.rng.randrange(len(out))
            return out[: i + 1] + [_reencode(out[i])] + out[i + 1 :]
        if kind == "corrupt":
            i = self.rng.randrange(len(out))
            out[i] = corrupt_element(out[i], self.rng)
        return out

    # ----------------------------------------------- RpcServer surface

    def status(self, caller: str):
        if self.fault_status:
            kind = self._pick_fault()
            if kind == "stall":
                raise RpcError(2, "injected stall on status")
            if kind in ("drop", "rate_limit"):
                raise RateLimitExceeded
        return self.inner.status(caller)

    def ping(self, caller: str, data: int):
        return self.inner.ping(caller, data)

    def metadata(self, caller: str):
        return self.inner.metadata(caller)

    def goodbye(self, caller: str, reason: int = 0):
        return self.inner.goodbye(caller, reason)

    def blocks_by_range(self, caller: str, req):
        return self._listy(
            "blocks_by_range",
            lambda: self.inner.blocks_by_range(caller, req),
        )

    def blocks_by_root(self, caller: str, roots):
        return self._listy(
            "blocks_by_root",
            lambda: self.inner.blocks_by_root(caller, roots),
        )

    def blob_sidecars_by_range(self, caller: str, req):
        return self._listy(
            "blob_sidecars_by_range",
            lambda: self.inner.blob_sidecars_by_range(caller, req),
        )

    def blob_sidecars_by_root(self, caller: str, identifiers):
        return self._listy(
            "blob_sidecars_by_root",
            lambda: self.inner.blob_sidecars_by_root(caller, identifiers),
        )
