"""Slot clocks: wall-time and manually-driven.

The port of `lighthouse_tpu/common/slot_clock.py`.

Role of common/slot_clock (SlotClock trait, SystemTimeSlotClock,
ManualSlotClock/TestingSlotClock): map wall time to slots and expose the
per-slot timing offsets the duties services key off (attestations at 1/3,
aggregates at 2/3 of a slot).
"""

import time


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> float:
        raise NotImplementedError

    def current_slot(self) -> int:
        t = self.now()
        if t < self.genesis_time:
            return 0
        return int(t - self.genesis_time) // self.seconds_per_slot

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        return self.now() - self.slot_start(self.current_slot())

    def duration_to_next_slot(self) -> float:
        return self.slot_start(self.current_slot() + 1) - self.now()

    def attestation_deadline(self, slot: int) -> float:
        """Attestations are produced 1/3 into the slot."""
        return self.slot_start(slot) + self.seconds_per_slot / 3

    def aggregate_deadline(self, slot: int) -> float:
        """Aggregates are published 2/3 into the slot."""
        return self.slot_start(slot) + 2 * self.seconds_per_slot / 3


class SystemTimeSlotClock(SlotClock):
    def now(self) -> float:
        return time.time()


class ManualSlotClock(SlotClock):
    """Testing clock: time moves only when told to (TestingSlotClock)."""

    def __init__(self, genesis_time: int, seconds_per_slot: int):
        super().__init__(genesis_time, seconds_per_slot)
        self._now = float(genesis_time)

    def now(self) -> float:
        return self._now

    def set_slot(self, slot: int):
        self._now = self.slot_start(slot)

    def advance_slot(self):
        self.set_slot(self.current_slot() + 1)

    def advance_seconds(self, s: float):
        self._now += s
