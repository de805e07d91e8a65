"""Spec fork choice over the proto-array (on_block / on_attestation /
get_head).

The port of `lighthouse_tpu/fork_choice/fork_choice.py`.

Role of consensus/fork_choice/src/fork_choice.rs (get_head:471,
on_block:623, on_attestation:918): tracks latest messages per validator,
turns vote movements + justified-state balances into proto-array score
deltas, applies proposer boost, and enforces attestation slot/epoch
validity windows. The store side (justified/finalized checkpoints and
their balances) is held inline, the `ForkChoiceStore` trait analog.
"""

from dataclasses import dataclass

from lighthouse_tpu_torch.fork_choice.proto_array import ProtoArray


@dataclass
class VoteTracker:
    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int | None = None  # None == no vote recorded yet


class ForkChoiceError(Exception):
    pass


class ForkChoice:
    def __init__(
        self,
        genesis_root: bytes,
        genesis_slot: int,
        justified_checkpoint,
        finalized_checkpoint,
        spec,
    ):
        self.spec = spec
        self.proto = ProtoArray(
            justified_epoch=justified_checkpoint[0],
            finalized_epoch=finalized_checkpoint[0],
        )
        self.proto.on_block(
            genesis_slot,
            genesis_root,
            None,
            justified_checkpoint[0],
            finalized_checkpoint[0],
        )
        self.justified_checkpoint = justified_checkpoint  # (epoch, root)
        self.finalized_checkpoint = finalized_checkpoint
        self.votes: dict[int, VoteTracker] = {}
        self.balances: list[int] = []
        self.proposer_boost_root: bytes | None = None
        self.current_slot = genesis_slot

    # -------------------------------------------------------------- clock

    def set_slot(self, slot: int):
        if slot < self.current_slot:
            raise ForkChoiceError("time cannot rewind")
        if slot > self.current_slot:
            self.proposer_boost_root = None
        self.current_slot = slot

    # ------------------------------------------------------------- blocks

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes,
        justified_checkpoint,
        finalized_checkpoint,
        is_timely: bool = False,
        execution_status: str = None,
        execution_block_hash: bytes | None = None,
    ):
        from lighthouse_tpu_torch.fork_choice.proto_array import ExecutionStatus

        if slot > self.current_slot:
            raise ForkChoiceError("block from the future")
        if parent_root not in self.proto.indices:
            raise ForkChoiceError("unknown parent")
        if justified_checkpoint[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = justified_checkpoint
        if finalized_checkpoint[0] > self.finalized_checkpoint[0]:
            self.finalized_checkpoint = finalized_checkpoint
        self.proto.on_block(
            slot,
            root,
            parent_root,
            justified_checkpoint[0],
            finalized_checkpoint[0],
            execution_status=execution_status or ExecutionStatus.IRRELEVANT,
            execution_block_hash=execution_block_hash,
        )
        if is_timely and slot == self.current_slot:
            self.proposer_boost_root = root

    # ------------------------------------------- optimistic-sync verdicts

    def is_optimistic(self, root: bytes) -> bool:
        return self.proto.is_optimistic(root)

    def on_valid_execution_payload(self, root: bytes):
        self.proto.on_valid_execution_payload(root)

    def on_invalid_execution_payload(
        self, root: bytes, latest_valid_hash: bytes | None = None
    ):
        self.proto.on_invalid_execution_payload(root, latest_valid_hash)

    # -------------------------------------------------------- attestations

    def on_attestation(
        self, validator_indices, beacon_block_root: bytes, target_epoch: int
    ):
        """Register latest-message votes (aggregates pass many indices).

        Queuing semantics: votes for future epochs are stored with
        next_epoch and only counted once their epoch arrives — matching
        the reference's queued-attestation handling."""
        if beacon_block_root not in self.proto.indices:
            raise ForkChoiceError("attestation for unknown block")
        for idx in validator_indices:
            vote = self.votes.setdefault(idx, VoteTracker())
            if vote.next_epoch is None or target_epoch > vote.next_epoch:
                vote.next_epoch = target_epoch
                vote.next_root = beacon_block_root

    # --------------------------------------------------------------- head

    def get_head(self, justified_balances) -> bytes:
        """Compute deltas from vote movement + balance changes, apply, and
        find the head from the justified root."""
        spec = self.spec
        old_balances = self.balances
        new_balances = justified_balances
        deltas = [0] * len(self.proto.nodes)
        current_epoch = (
            self.current_slot // spec.SLOTS_PER_EPOCH
        )

        for idx, vote in self.votes.items():
            if vote.next_root != vote.current_root and (
                vote.next_epoch is not None
                and vote.next_epoch <= current_epoch
            ):
                old_bal = (
                    old_balances[idx] if idx < len(old_balances) else 0
                )
                new_bal = (
                    new_balances[idx] if idx < len(new_balances) else 0
                )
                cur = self.proto.indices.get(vote.current_root)
                nxt = self.proto.indices.get(vote.next_root)
                if cur is not None:
                    deltas[cur] -= old_bal
                if nxt is not None:
                    deltas[nxt] += new_bal
                vote.current_root = vote.next_root
            elif vote.current_root in self.proto.indices:
                # balance may have changed without a vote move
                old_bal = (
                    old_balances[idx] if idx < len(old_balances) else 0
                )
                new_bal = (
                    new_balances[idx] if idx < len(new_balances) else 0
                )
                if old_bal != new_bal:
                    i = self.proto.indices[vote.current_root]
                    deltas[i] += new_bal - old_bal

        # proposer boost: transient score on the timely block of this slot
        boost_amount = 0
        boost_idx = None
        if self.proposer_boost_root is not None:
            boost_idx = self.proto.indices.get(self.proposer_boost_root)
            if boost_idx is not None:
                committee_weight = sum(new_balances) // spec.SLOTS_PER_EPOCH
                boost_amount = (
                    committee_weight * spec.PROPOSER_SCORE_BOOST // 100
                )
                deltas[boost_idx] += boost_amount

        self.proto.apply_score_changes(
            deltas,
            self.justified_checkpoint[0],
            self.finalized_checkpoint[0],
        )

        # remove the transient boost right away so it does not accumulate
        if boost_amount and boost_idx is not None:
            undo = [0] * len(self.proto.nodes)
            undo[boost_idx] = -boost_amount
            self.proto.apply_score_changes(
                undo,
                self.justified_checkpoint[0],
                self.finalized_checkpoint[0],
            )

        self.balances = list(new_balances)
        return self.proto.find_head(self.justified_checkpoint[1])

    def prune(self):
        self.proto.prune(self.finalized_checkpoint[1])
