"""Array-backed LMD-GHOST fork-choice DAG.

The port of `lighthouse_tpu/fork_choice/proto_array.py`.

Role of the reference's consensus/proto_array crate
(proto_array.rs:143 apply_score_changes, :607 find_head,
proto_array_fork_choice.rs:255): blocks live in a flat append-only array;
each node caches its best child/descendant; vote changes arrive as score
deltas that are accumulated up the parent chain in one reverse pass, so
head-finding is O(depth) pointer chasing, not tree search.
"""

from dataclasses import dataclass, field


class ExecutionStatus:
    """Optimistic-sync payload verdict per node (reference
    proto_array.rs ExecutionStatus: Valid/Invalid/Optimistic/Irrelevant)."""

    IRRELEVANT = "irrelevant"  # pre-merge block, no payload
    OPTIMISTIC = "optimistic"  # payload imported without a verdict yet
    VALID = "valid"
    INVALID = "invalid"


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None
    justified_epoch: int
    finalized_epoch: int
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None
    execution_status: str = ExecutionStatus.IRRELEVANT
    execution_block_hash: bytes | None = None


class ProtoArrayError(Exception):
    pass


@dataclass
class ProtoArray:
    justified_epoch: int
    finalized_epoch: int
    nodes: list = field(default_factory=list)
    indices: dict = field(default_factory=dict)

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        justified_epoch: int,
        finalized_epoch: int,
        execution_status: str = ExecutionStatus.IRRELEVANT,
        execution_block_hash: bytes | None = None,
    ):
        if root in self.indices:
            return
        parent = (
            self.indices.get(parent_root)
            if parent_root is not None
            else None
        )
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
            execution_status=execution_status,
            execution_block_hash=execution_block_hash,
        )
        idx = len(self.nodes)
        self.indices[root] = idx
        self.nodes.append(node)
        if parent is not None:
            self._maybe_update_best_child(parent, idx)

    def apply_score_changes(
        self, deltas, justified_epoch: int, finalized_epoch: int
    ):
        """`deltas[i]` is the signed weight change for node i. One reverse
        pass: apply delta, push into parent's delta, refresh best links."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("delta length mismatch")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        deltas = list(deltas)
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            delta = deltas[i]
            node.weight += delta
            if node.weight < 0:
                raise ProtoArrayError("negative node weight")
            if node.parent is not None:
                deltas[node.parent] += delta
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child(node.parent, i)

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        if node.execution_status == ExecutionStatus.INVALID:
            return False
        return (
            node.justified_epoch == self.justified_epoch
            or self.justified_epoch == 0
        ) and (
            node.finalized_epoch == self.finalized_epoch
            or self.finalized_epoch == 0
        )

    # ------------------------------------------- optimistic-sync verdicts

    def is_optimistic(self, root: bytes) -> bool:
        """True if the block's payload (or any ancestor's) is unverified."""
        idx = self.indices.get(root)
        if idx is None:
            raise ProtoArrayError("unknown root")
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == ExecutionStatus.OPTIMISTIC:
                return True
            if node.execution_status == ExecutionStatus.VALID:
                return False
            idx = node.parent
        return False

    def on_valid_execution_payload(self, root: bytes):
        """An engine VALID verdict for `root` proves every optimistic
        ancestor valid too (proto_array.rs propagate_execution_payload_
        validation)."""
        idx = self.indices.get(root)
        if idx is None:
            raise ProtoArrayError("unknown root")
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == ExecutionStatus.INVALID:
                raise ProtoArrayError(
                    "valid verdict for a block marked invalid"
                )
            if node.execution_status in (
                ExecutionStatus.VALID,
                ExecutionStatus.IRRELEVANT,
            ):
                break
            node.execution_status = ExecutionStatus.VALID
            idx = node.parent

    def on_invalid_execution_payload(
        self, root: bytes, latest_valid_hash: bytes | None = None
    ):
        """An engine INVALID verdict: mark `root`, its descendants, and
        its ancestors back to (exclusive) latest_valid_hash invalid, then
        refresh best-child links so the head routes around them
        (proto_array.rs process_execution_status_invalidation)."""
        idx = self.indices.get(root)
        if idx is None:
            raise ProtoArrayError("unknown root")
        bad = {idx}
        if latest_valid_hash is not None:
            # ancestors up to (exclusive) the last valid payload. With no
            # latest_valid_hash the engine only proved THIS payload
            # invalid — do not over-invalidate the optimistic chain.
            walk = idx
            while walk is not None:
                node = self.nodes[walk]
                if (
                    node.execution_block_hash == latest_valid_hash
                    or node.execution_status
                    in (ExecutionStatus.VALID, ExecutionStatus.IRRELEVANT)
                ):
                    break
                bad.add(walk)
                walk = node.parent
        # all descendants of any invalidated node (parents precede
        # children in the array, so one forward pass from the earliest
        # invalidated index covers every descendant)
        for i in range(min(bad) + 1, len(self.nodes)):
            if self.nodes[i].parent in bad:
                bad.add(i)
        for i in bad:
            self.nodes[i].execution_status = ExecutionStatus.INVALID
            self.nodes[i].best_child = None
            self.nodes[i].best_descendant = None
        # refresh best links bottom-up so invalid branches are demoted
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child(node.parent, i)

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(
                self.nodes[node.best_descendant]
            )
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child(self, parent_idx: int, child_idx: int):
        parent = self.nodes[parent_idx]
        child = self.nodes[child_idx]
        child_leads = self._node_leads_to_viable_head(child)
        child_best = (
            child.best_descendant
            if child.best_descendant is not None
            else child_idx
        )
        if parent.best_child is None:
            if child_leads:
                parent.best_child = child_idx
                parent.best_descendant = child_best
            return
        if parent.best_child == child_idx:
            if not child_leads:
                # demote: rescan children
                self._rescan_children(parent_idx)
            else:
                parent.best_descendant = child_best
            return
        current_best = self.nodes[parent.best_child]
        if not child_leads:
            return
        if not self._node_leads_to_viable_head(current_best):
            parent.best_child = child_idx
            parent.best_descendant = child_best
            return
        if (child.weight, child.root) > (
            current_best.weight,
            current_best.root,
        ):
            parent.best_child = child_idx
            parent.best_descendant = child_best

    def _rescan_children(self, parent_idx: int):
        parent = self.nodes[parent_idx]
        parent.best_child = None
        parent.best_descendant = None
        for i, n in enumerate(self.nodes):
            if n.parent == parent_idx:
                self._maybe_update_best_child(parent_idx, i)

    def find_head(self, justified_root: bytes) -> bytes:
        idx = self.indices.get(justified_root)
        if idx is None:
            raise ProtoArrayError("unknown justified root")
        node = self.nodes[idx]
        best = (
            node.best_descendant
            if node.best_descendant is not None
            else idx
        )
        head = self.nodes[best]
        if not self._node_is_viable_for_head(head):
            raise ProtoArrayError("head not viable")
        return head.root

    def prune(self, finalized_root: bytes):
        """Drop everything not descended from the finalized root."""
        fin_idx = self.indices.get(finalized_root)
        if fin_idx is None:
            raise ProtoArrayError("unknown finalized root")
        keep = set()
        for i in range(fin_idx, len(self.nodes)):
            node = self.nodes[i]
            if i == fin_idx or (
                node.parent is not None and node.parent in keep
            ):
                keep.add(i)
        remap = {}
        new_nodes = []
        for i in sorted(keep):
            remap[i] = len(new_nodes)
            new_nodes.append(self.nodes[i])
        for n in new_nodes:
            n.parent = (
                remap.get(n.parent) if n.parent is not None else None
            )
            n.best_child = (
                remap.get(n.best_child)
                if n.best_child is not None
                else None
            )
            n.best_descendant = (
                remap.get(n.best_descendant)
                if n.best_descendant is not None
                else None
            )
        self.nodes = new_nodes
        self.indices = {n.root: i for i, n in enumerate(new_nodes)}
