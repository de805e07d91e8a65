"""Event bus: head/block/attestation/finalized_checkpoint streams.

The port of `lighthouse_tpu/beacon_chain/events.py`.

Role of the reference's SSE machinery (beacon_chain/src/events.rs +
/eth/v1/events): subsystems publish typed events; subscribers (the SSE
route, the validator client, tests) consume bounded queues.
"""

import queue
import threading

from lighthouse_tpu_torch.common.locks import TimedLock

TOPICS = (
    "head",
    "block",
    "attestation",
    "finalized_checkpoint",
    "chain_reorg",
)


class EventBus:
    def __init__(self, capacity: int = 1024):
        self._subs: dict[str, list] = {t: [] for t in TOPICS}
        self._lock = TimedLock("events.subscribers")
        self.capacity = capacity

    def subscribe(self, topics):
        q = queue.Queue(maxsize=self.capacity)
        with self._lock:
            for t in topics:
                self._subs[t].append(q)
        return q

    def unsubscribe(self, q):
        """Detach a subscriber queue from every topic — callers must pair
        this with subscribe() or the bus leaks dead queues."""
        with self._lock:
            for subs in self._subs.values():
                try:
                    subs.remove(q)
                except ValueError:
                    pass

    def publish(self, topic: str, payload: dict):
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for q in subs:
            try:
                q.put_nowait({"event": topic, "data": payload})
            except queue.Full:
                pass  # slow consumer loses events (bounded, as reference)
