"""The port's fork choice (lighthouse_tpu_torch.fork_choice) against the JAX
package's, exactly, on the CPU.

The same scripted and seeded sequences of on_block / on_attestation /
get_head / set_slot / payload verdicts / prune go through both packages'
`ForkChoice`; after every step the head, every proto-array node (weights,
best child and descendant, execution status), the justified and finalized
checkpoints and the vote trackers must be equal, and a step that raises in
one must raise the same error in the other. The scripted cases are the
reference's `tests/test_fork_choice.py`, with a reorg and an invalid-payload
verdict added. Host Python only: no JAX graph."""

import numpy as np
import pytest

from lighthouse_tpu.fork_choice import ForkChoice as RefForkChoice
from lighthouse_tpu.fork_choice import ProtoArray as RefProtoArray
from lighthouse_tpu.fork_choice.proto_array import ExecutionStatus as RefStatus
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch.fork_choice import ForkChoice, ProtoArray
from lighthouse_tpu_torch.fork_choice.proto_array import ExecutionStatus, ProtoArrayError
from lighthouse_tpu_torch.types.spec import minimal_spec


def r(i: int) -> bytes:
    return bytes([i]) * 32


def _make(cls, spec):
    return cls(genesis_root=r(0), genesis_slot=0, justified_checkpoint=(0, r(0)),
               finalized_checkpoint=(0, r(0)), spec=spec)


def _snapshot(fc):
    nodes = [(n.slot, n.root, n.parent, n.justified_epoch, n.finalized_epoch, n.weight, n.best_child,
              n.best_descendant, n.execution_status, n.execution_block_hash) for n in fc.proto.nodes]
    votes = sorted((i, v.current_root, v.next_root, v.next_epoch) for i, v in fc.votes.items())
    return (fc.justified_checkpoint, fc.finalized_checkpoint, fc.current_slot, fc.proposer_boost_root,
            fc.proto.justified_epoch, fc.proto.finalized_epoch, nodes, sorted(fc.proto.indices.items()),
            votes, list(fc.balances))


class Pair:
    """One ForkChoice of each package, driven by the same calls."""

    def __init__(self):
        self.ref = _make(RefForkChoice, ref_minimal_spec())
        self.port = _make(ForkChoice, minimal_spec())

    def __call__(self, method, *args, **kw):
        out = []
        for fc in (self.ref, self.port):
            try:
                out.append(("ok", getattr(fc, method)(*args, **kw)))
            except Exception as e:  # the same error in both, or a mismatch below
                out.append(("raised", type(e).__name__, str(e)))
        assert out[0] == out[1], (method, args, out)
        assert _snapshot(self.ref) == _snapshot(self.port), (method, args)
        if out[0][0] == "raised":
            raise RuntimeError(out[0][2])
        return out[0][1]


def test_single_chain_head():
    fc = Pair()
    fc("set_slot", 3)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)))
    fc("on_block", 2, r(2), r(1), (0, r(0)), (0, r(0)))
    assert fc("get_head", [32] * 8) == r(2)


def test_votes_pick_heavier_fork_then_reorg():
    """Two children of genesis; the votes move and the head reorgs."""
    fc = Pair()
    fc("set_slot", 2)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)))
    fc("on_block", 1, r(2), r(0), (0, r(0)), (0, r(0)))
    balances = [32] * 10
    fc("on_attestation", [0, 1, 2], r(1), 0)
    fc("on_attestation", [3, 4, 5, 6, 7, 8], r(2), 0)
    assert fc("get_head", balances) == r(2)
    fc("on_attestation", [3, 4, 5, 6, 7], r(1), 1)
    assert fc("get_head", balances) == r(2)  # epoch 1 has not arrived
    fc("set_slot", 8)
    assert fc("get_head", balances) == r(1)
    # a child of the losing fork with the next epoch's votes wins it back
    fc("on_block", 8, r(3), r(2), (0, r(0)), (0, r(0)))
    fc("on_attestation", list(range(10)), r(3), 1)
    fc("on_attestation", list(range(10)), r(3), 2)
    fc("set_slot", 16)
    assert fc("get_head", balances) == r(3)


def test_tie_breaks_by_root():
    fc = Pair()
    fc("set_slot", 1)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)))
    fc("on_block", 1, r(2), r(0), (0, r(0)), (0, r(0)))
    assert fc("get_head", [32] * 4) == r(2)


@pytest.mark.parametrize("case", ["unknown_parent", "future_block", "unknown_vote_target"])
def test_refusals_are_equal(case):
    fc = Pair()
    fc("set_slot", 5)
    with pytest.raises(RuntimeError):
        if case == "unknown_parent":
            fc("on_block", 1, r(9), r(8), (0, r(0)), (0, r(0)))
        elif case == "future_block":
            fc("on_block", 6, r(1), r(0), (0, r(0)), (0, r(0)))
        else:
            fc("on_attestation", [0], r(7), 0)


def test_justified_viability_filters_forks():
    fc = Pair()
    fc("set_slot", 10)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)))
    fc("on_block", 2, r(2), r(1), (1, r(1)), (0, r(0)))  # justifies epoch 1
    fc("on_block", 2, r(3), r(1), (0, r(0)), (0, r(0)))
    fc("on_attestation", list(range(8)), r(3), 0)
    assert fc.port.justified_checkpoint == (1, r(1))
    assert fc("get_head", [32] * 8) == r(2)


def test_prune_keeps_finalized_subtree():
    out = []
    for cls in (RefProtoArray, ProtoArray):
        pa = cls(justified_epoch=0, finalized_epoch=0)
        pa.on_block(0, r(0), None, 0, 0)
        pa.on_block(1, r(1), r(0), 0, 0)
        pa.on_block(2, r(2), r(1), 0, 0)
        pa.on_block(1, r(9), r(0), 0, 0)  # stale fork
        pa.prune(r(1))
        out.append((sorted(pa.indices.items()), [(n.root, n.parent, n.best_child, n.best_descendant)
                                                  for n in pa.nodes], pa.find_head(r(1))))
    assert out[0] == out[1]
    assert out[1][2] == r(2) and {k for k, _ in out[1][0]} == {r(1), r(2)}
    with pytest.raises(ProtoArrayError):
        pa.find_head(r(0))


def test_balance_changes_reflected():
    fc = Pair()
    fc("set_slot", 1)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)))
    fc("on_block", 1, r(2), r(0), (0, r(0)), (0, r(0)))
    fc("on_attestation", [0], r(1), 0)
    fc("on_attestation", [1], r(2), 0)
    assert fc("get_head", [64, 32]) == r(1)
    assert fc("get_head", [8, 32]) == r(2)


def test_invalid_payload_verdict_routes_the_head_around():
    """An optimistic chain whose tip an engine calls INVALID back to a
    latest valid hash: the head falls back to the last valid block; a VALID
    verdict on the other branch clears its optimism. The statuses are the
    same strings in both packages."""
    assert (RefStatus.OPTIMISTIC, RefStatus.VALID, RefStatus.INVALID) == (
        ExecutionStatus.OPTIMISTIC, ExecutionStatus.VALID, ExecutionStatus.INVALID)
    fc = Pair()
    fc("set_slot", 4)
    opt = dict(execution_status=ExecutionStatus.OPTIMISTIC)
    fc("on_block", 1, r(1), r(0), (0, r(0)), (0, r(0)), execution_status=ExecutionStatus.VALID,
       execution_block_hash=b"\x01" * 32)
    fc("on_block", 2, r(2), r(1), (0, r(0)), (0, r(0)), execution_block_hash=b"\x02" * 32, **opt)
    fc("on_block", 3, r(3), r(2), (0, r(0)), (0, r(0)), execution_block_hash=b"\x03" * 32, **opt)
    fc("on_block", 2, r(4), r(1), (0, r(0)), (0, r(0)), execution_block_hash=b"\x04" * 32, **opt)
    fc("on_attestation", [0, 1, 2], r(3), 0)
    fc("on_attestation", [3], r(4), 0)
    assert fc("get_head", [32] * 4) == r(3)
    assert fc("is_optimistic", r(3)) is True
    fc("on_invalid_execution_payload", r(3), b"\x01" * 32)
    assert fc("get_head", [32] * 4) == r(4)
    fc("on_valid_execution_payload", r(4))
    assert fc("is_optimistic", r(4)) is False
    with pytest.raises(RuntimeError):
        fc("on_valid_execution_payload", r(2))  # marked invalid with r(3)'s ancestors


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequences_equal(seed):
    """A seeded random tree of 40 blocks over 5 epochs, votes from 24
    validators moving between branches, justification and finalization
    advancing on some blocks, optimistic payloads with late verdicts,
    balance changes and a prune: equal after every step."""
    rng = np.random.default_rng(seed)
    fc = Pair()
    spe = minimal_spec().SLOTS_PER_EPOCH
    blocks = [(0, r(0))]  # (slot, root)
    checkpoints = [(0, r(0))]
    balances = [32] * 24
    slot = 0
    for step in range(40):
        slot += int(rng.integers(0, 2))
        fc("set_slot", slot)
        parent_slot, parent = blocks[int(rng.integers(max(0, len(blocks) - 6), len(blocks)))]
        bslot = max(parent_slot + 1, slot)
        if bslot > slot:
            slot = bslot
            fc("set_slot", slot)
        root = r(step + 1)
        just = checkpoints[-1]
        if rng.random() < 0.15 and bslot // spe > just[0]:
            checkpoints.append((bslot // spe, parent))
            just = checkpoints[-1]
        fin = checkpoints[-2] if len(checkpoints) > 1 and rng.random() < 0.5 else (0, r(0))
        kw = {}
        if rng.random() < 0.3:
            kw = dict(execution_status=ExecutionStatus.OPTIMISTIC, execution_block_hash=bytes([step + 1]) * 32)
        fc("on_block", bslot, root, parent, just, fin, is_timely=bool(rng.random() < 0.5), **kw)
        blocks.append((bslot, root))
        voters = [int(v) for v in rng.choice(24, size=int(rng.integers(1, 9)), replace=False)]
        target = blocks[int(rng.integers(0, len(blocks)))][1]
        fc("on_attestation", voters, target, slot // spe + int(rng.integers(0, 2)))
        if rng.random() < 0.2:
            balances[int(rng.integers(0, 24))] = int(rng.integers(0, 64))
        if rng.random() < 0.1 and kw:
            try:
                fc("on_invalid_execution_payload", root, None)
            except RuntimeError:
                pass
        try:
            fc("get_head", list(balances))
        except RuntimeError:
            pass  # no viable head: the same refusal in both
    try:
        fc("prune")
        fc("get_head", list(balances))
    except RuntimeError:
        pass
