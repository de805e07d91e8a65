"""The port's block processing (lighthouse_tpu_torch.state_processing:
per_block, signature_sets, genesis) against the JAX package, exactly, on
the CPU.

Blocks and states pass between the packages as SSZ bytes. For each kind of
operation the port's `per_block_processing` and the reference's run on the
same decoded block from the same state: post-state roots and balances
equal (which holds the port's per-block constants exact), or the same
error. Each signature-set maker gives the same signing root, key bytes
and signature bytes. The strategies give the reference's verdicts after
the same verify calls. The port runs on device="cpu" and verifies on "ref" or
not at all (the one block on the "gpu" backend's plain versions is in
test_torch_harness.py). No JAX graph is compiled."""

from types import SimpleNamespace

import pytest

from lighthouse_tpu import bls as ref_bls
from lighthouse_tpu.state_processing import genesis as ref_genesis
from lighthouse_tpu.state_processing import signature_sets as ref_sigsets
from lighthouse_tpu.state_processing.per_block import BlockProcessingError as RefError
from lighthouse_tpu.state_processing.per_block import BlockSignatureStrategy as RefStrategy
from lighthouse_tpu.state_processing.per_block import per_block_processing as ref_per_block
from lighthouse_tpu.state_processing.pubkey_cache import PubkeyCache as RefCache
from lighthouse_tpu.types.containers import types_for as ref_types_for
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.bls import api
from lighthouse_tpu_torch.eth1 import DepositTree
from lighthouse_tpu_torch.harness import Harness
from lighthouse_tpu_torch.state_processing import genesis, per_block
from lighthouse_tpu_torch.state_processing import signature_sets as sigsets
from lighthouse_tpu_torch.state_processing.helpers import get_domain
from lighthouse_tpu_torch.state_processing.per_block import (
    BlockProcessingError,
    BlockSignatureStrategy,
    SignatureCollector,
    per_block_processing,
)
from lighthouse_tpu_torch.state_processing.per_slot import process_slots
from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.helpers import compute_domain, compute_signing_root
from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH, minimal_spec

N = 16
PHASE0 = 2**64 - 1
NOV = BlockSignatureStrategy.NO_VERIFICATION


def _specs(altair_epoch):
    """(reference spec, port spec): exits allowed at once, as
    tests/test_operations.py has them."""
    kw = {"ALTAIR_FORK_EPOCH": altair_epoch, "SHARD_COMMITTEE_PERIOD": 0}
    return ref_minimal_spec(**kw), minimal_spec(**kw)


def _encode(obj):
    return type(obj).encode(obj)


@pytest.fixture(scope="module")
def chains():
    """A port harness a fork, 2 slots in (pending attestations of slot 2),
    built without verification."""
    out = {}
    for fork, epoch in (("phase0", PHASE0), ("altair", 0)):
        ref_spec, spec = _specs(epoch)
        h = Harness(spec, N, backend="fake", device="cpu")
        for slot in (1, 2):
            h.advance_slot_with_block(slot, strategy=NOV)
        out[fork] = (ref_spec, h)
    return out


def _apply_both(ref_spec, h, signed_block, mutate=None):
    """The block on the harness's state advanced to its slot, through the
    reference's per_block_processing and the port's (NO_VERIFICATION;
    deposits verify on each package's default backend). Returns the two
    post-states, or the one error both raised."""
    spec = h.spec
    pre = process_slots(h.state.copy(), signed_block.message.slot, spec, device="cpu")
    if mutate is not None:
        mutate(pre)
    fork = spec.fork_name_at_epoch(spec.slot_to_epoch(pre.slot))
    rt = ref_types_for(ref_spec)
    ref_state = rt.state_classes[fork].decode(_encode(pre))
    ref_block = rt.signed_block_classes[fork].decode(_encode(signed_block))
    errors = []
    try:
        ref_per_block(ref_state, ref_block, ref_spec, RefStrategy.NO_VERIFICATION, RefCache())
        errors.append(None)
    except RefError as e:
        errors.append(str(e))
    try:
        per_block_processing(pre, signed_block, spec, NOV, PubkeyCache(device="cpu"), device="cpu")
        errors.append(None)
    except BlockProcessingError as e:
        errors.append(str(e))
    assert errors[0] == errors[1], errors
    if errors[0] is not None:
        return errors[0]
    assert list(ref_state.balances) == list(pre.balances)
    assert type(ref_state).hash_tree_root(ref_state) == type(pre).hash_tree_root(pre)
    return ref_state, pre


# ---------------------------------------------------------------- deposits


def _deposit_data(t, spec, sk, amount):
    data = t.DepositData(pubkey=sk.public_key().to_bytes(), withdrawal_credentials=b"\x00" * 32,
                         amount=amount)
    msg = t.DepositMessage(pubkey=data.pubkey, withdrawal_credentials=data.withdrawal_credentials,
                           amount=amount)
    domain = compute_domain(spec.DOMAIN_DEPOSIT, spec.GENESIS_FORK_VERSION, b"\x00" * 32)
    data.signature = sk.sign(compute_signing_root(t.DepositMessage.hash_tree_root(msg), domain)).to_bytes()
    return data


def _deposit_chain(data):
    """A phase0 harness whose eth1 data holds `data` as deposit N, and its
    Deposit with the proof against that root."""
    ref_spec, spec = _specs(PHASE0)
    h = Harness(spec, N, backend="fake", device="cpu")
    t = h.t
    tree = DepositTree()
    for _ in range(N):
        tree.push(b"\x00" * 32)  # the genesis deposits, already consumed
    tree.push(t.DepositData.hash_tree_root(data))
    h.state.eth1_data = t.Eth1Data(deposit_root=tree.root(), deposit_count=len(tree),
                                   block_hash=b"\x22" * 32)
    return ref_spec, h, t.Deposit(proof=tree.proof(N), data=data)


def _deposit_block(h, deposit):
    """The block carrying `deposit`, built without the harness's trial run
    (whose deposit check would run the plain kernels a second time)."""
    from lighthouse_tpu_torch.state_processing.helpers import get_beacon_proposer_index

    spec, t = h.spec, h.t
    state = process_slots(h.state.copy(), 1, spec, device="cpu")
    block = t.block_classes["phase0"](
        slot=1, proposer_index=get_beacon_proposer_index(state, spec),
        parent_root=h.head_block_root(state), state_root=b"\x00" * 32,
        body=t.block_body_classes["phase0"](randao_reveal=h.randao_reveal(1), eth1_data=state.eth1_data,
                                            deposits=[deposit]))
    return t.signed_block_classes["phase0"](message=block, signature=bls.INFINITY_SIGNATURE_BYTES)


def test_deposit_verifies_on_the_default_backend_on_the_callers_device(monkeypatch):
    """The new validator's deposit signature verifies on the default
    backend ("gpu" unless changed; "ref" here, the one plain-kernel block
    is in test_torch_harness.py) on the device block processing was
    given."""
    spec = _specs(PHASE0)[1]
    data = _deposit_data(types_for(spec), spec, bls.SecretKey(12345), spec.MAX_EFFECTIVE_BALANCE)
    ref_spec, h, deposit = _deposit_chain(data)
    assert api.default_backend() == "gpu"
    monkeypatch.setattr(api, "default_backend", lambda: "ref")
    seen = []
    real = bls.verify_signature_sets
    monkeypatch.setattr(bls, "verify_signature_sets",
                        lambda sets, **kw: seen.append(kw) or real(sets, **kw))
    _, post = _apply_both(ref_spec, h, _deposit_block(h, deposit))
    assert [(kw["backend"], kw["device"]) for kw in seen] == [("ref", "cpu")]
    assert len(post.validators) == N + 1 and post.eth1_deposit_index == N + 1
    assert bytes(post.validators[N].pubkey) == bls.SecretKey(12345).public_key().to_bytes()


@pytest.mark.parametrize("case", ["bad_proof", "invalid_signature", "top_up"])
def test_deposit_cases_equal_reference(case, monkeypatch):
    spec = _specs(PHASE0)[1]
    t = types_for(spec)
    sk = bls.SecretKey(777)
    data = _deposit_data(t, spec, sk, 32 * 10**9)
    if case == "invalid_signature":
        data.signature = bls.SecretKey(999).sign(b"wrong").to_bytes()
    if case == "top_up":  # an existing validator's key: no signature check
        data = _deposit_data(t, spec, bls.interop_keypairs(4)[3].sk, spec.EFFECTIVE_BALANCE_INCREMENT)
    ref_spec, h, deposit = _deposit_chain(data)
    monkeypatch.setattr(api, "default_backend", lambda: "ref")
    block = _deposit_block(h, deposit)
    if case == "bad_proof":
        def mutate(state):
            state.eth1_data.deposit_root = b"\x09" * 32

        assert _apply_both(ref_spec, h, block, mutate=mutate) == "deposit: bad merkle proof"
        return
    _, post = _apply_both(ref_spec, h, block)
    assert post.eth1_deposit_index == N + 1
    assert len(post.validators) == N  # skipped, or merged into validator 3
    if case == "top_up":
        assert post.balances[3] == h.state.balances[3] + spec.EFFECTIVE_BALANCE_INCREMENT


# -------------------------------------------------------- other operations


def _exit(h, idx):
    t, spec = h.t, h.spec
    msg = t.VoluntaryExit(epoch=0, validator_index=idx)
    root = compute_signing_root(t.VoluntaryExit.hash_tree_root(msg),
                                get_domain(h.state, spec.DOMAIN_VOLUNTARY_EXIT, 0, spec))
    return t.SignedVoluntaryExit(message=msg, signature=h.keypairs[idx].sk.sign(root).to_bytes())


def _proposer_slashing(h, proposer):
    t, spec = h.t, h.spec
    domain = get_domain(h.state, spec.DOMAIN_BEACON_PROPOSER, 0, spec)

    def signed(state_root):
        hd = t.BeaconBlockHeader(slot=h.state.slot, proposer_index=proposer, parent_root=b"\x01" * 32,
                                 state_root=state_root, body_root=b"\x03" * 32)
        root = compute_signing_root(t.BeaconBlockHeader.hash_tree_root(hd), domain)
        return t.SignedBeaconBlockHeader(message=hd, signature=h.keypairs[proposer].sk.sign(root).to_bytes())

    return t.ProposerSlashing(signed_header_1=signed(b"\x0a" * 32), signed_header_2=signed(b"\x0b" * 32))


def _attester_slashing(h, victims):
    t, spec = h.t, h.spec
    domain = get_domain(h.state, spec.DOMAIN_BEACON_ATTESTER, 0, spec)

    def indexed(target_root):
        data = t.AttestationData(slot=0, index=0, beacon_block_root=b"\x01" * 32,
                                 source=t.Checkpoint(epoch=0, root=b"\x02" * 32),
                                 target=t.Checkpoint(epoch=0, root=target_root))
        root = compute_signing_root(t.AttestationData.hash_tree_root(data), domain)
        sig = h._sign_aggregate(victims, root)
        return t.IndexedAttestation(attesting_indices=victims, data=data, signature=sig)

    return t.AttesterSlashing(attestation_1=indexed(b"\x0c" * 32), attestation_2=indexed(b"\x0d" * 32))


def _partial(h, atts):
    """The pending attestations with a bit cleared in the first, plus a
    repeat of the second (which earns no new flag)."""
    first = atts[0].copy()
    first.aggregation_bits = [i != 0 for i in range(len(first.aggregation_bits))]
    return [first] + list(atts[1:]) + [atts[-1]]


OPERATIONS = {
    "voluntary_exit": lambda h: {"voluntary_exits": [_exit(h, 3)]},
    "proposer_slashing": lambda h: {"proposer_slashings": [_proposer_slashing(h, 5)]},
    "attester_slashing": lambda h: {"attester_slashings": [_attester_slashing(h, [2, 9])]},
    "attestations": lambda h: {"attestations": _partial(h, h.pending_attestations)},
}


@pytest.mark.parametrize("fork", ["phase0", "altair"])
@pytest.mark.parametrize("op", sorted(OPERATIONS))
def test_operation_equals_reference(chains, fork, op):
    ref_spec, h = chains[fork]
    kw = OPERATIONS[op](h)
    block = h.produce_block(h.state.slot + 1, kw.pop("attestations", []), **kw)
    ref_state, post = _apply_both(ref_spec, h, block)
    if op == "voluntary_exit":
        assert post.validators[3].exit_epoch != FAR_FUTURE_EPOCH
    if op == "proposer_slashing":
        assert post.validators[5].slashed
    if op == "attester_slashing":
        assert post.validators[2].slashed and post.validators[9].slashed


def test_sync_aggregate_partial_participation_equals_reference(chains):
    ref_spec, h = chains["altair"]
    state = process_slots(h.state.copy(), h.state.slot + 1, h.spec, device="cpu")
    agg = h.make_sync_aggregate(state, h.head_block_root(state))
    agg.sync_committee_bits = [i % 3 != 0 for i in range(len(agg.sync_committee_bits))]
    block = h.produce_block(h.state.slot + 1, h.pending_attestations, sync_aggregate=agg)
    _, post = _apply_both(ref_spec, h, block)
    assert not all(block.message.body.sync_aggregate.sync_committee_bits)


def test_every_operation_in_one_block_equals_reference(chains):
    """Slashings before the attestations and the sync aggregate: the
    per-block proposer index and base reward stay the reference's
    per-call values."""
    ref_spec, h = chains["altair"]
    kw = {}
    for op in ("voluntary_exit", "proposer_slashing", "attester_slashing"):
        kw.update(OPERATIONS[op](h))
    block = h.produce_block(h.state.slot + 1, _partial(h, h.pending_attestations), **kw)
    _, post = _apply_both(ref_spec, h, block)
    assert sum(v.slashed for v in post.validators) == 3


@pytest.mark.parametrize("case", ["wrong_proposer", "stale_attestation", "unsorted_indices"])
def test_invalid_blocks_raise_like_reference(chains, case):
    ref_spec, h = chains["phase0"]
    slot = h.state.slot + 1
    if case == "wrong_proposer":
        block = h.produce_block(slot, [])
        block.message.proposer_index = (block.message.proposer_index + 1) % N
        assert _apply_both(ref_spec, h, block) == "wrong proposer index"
    elif case == "stale_attestation":  # slot 2's attestations at slot 11
        block = h.produce_block(slot + h.spec.SLOTS_PER_EPOCH, [])
        block.message.body.attestations = list(h.pending_attestations)
        assert _apply_both(ref_spec, h, block) == "attestation: inclusion window"
    else:
        sl = _attester_slashing(h, [2, 9])
        sl.attestation_1.attesting_indices = [9, 2]
        block = h.produce_block(slot, [], attester_slashings=[_attester_slashing(h, [2, 9])])
        block.message.body.attester_slashings = [sl]
        assert _apply_both(ref_spec, h, block) == "indexed attestation: not sorted/unique"


# ------------------------------------------------------------ signature sets


@pytest.fixture(scope="module")
def set_inputs(chains):
    """One altair state in both packages' types, a signature, and every
    object a set maker takes (port objects; the reference's are their SSZ
    decodings)."""
    ref_spec, h = chains["altair"]
    spec, t = h.spec, h.t
    state = process_slots(h.state.copy(), h.state.slot + 1, spec, device="cpu")
    block = h.produce_block(state.slot, h.pending_attestations)
    sig = bls.SecretKey(3).sign(b"any").to_bytes()
    contribution = t.SyncCommitteeContribution(
        slot=state.slot - 1, beacon_block_root=b"\x07" * 32, subcommittee_index=1,
        aggregation_bits=[i % 2 == 0 for i in range(max(spec.SYNC_COMMITTEE_SIZE // 4, 1))],
        signature=sig)
    cap = t.ContributionAndProof(aggregator_index=4, contribution=contribution, selection_proof=sig)
    objs = {
        "signed_block": block,
        "block": block.message,
        "signed_header": _proposer_slashing(h, 6).signed_header_1,
        "proposer_slashing": _proposer_slashing(h, 6),
        "indexed": _attester_slashing(h, [1, 4, 7]).attestation_1,
        "attester_slashing": _attester_slashing(h, [1, 4, 7]),
        "deposit_data": _deposit_data(t, spec, bls.SecretKey(5), 32 * 10**9),
        "signed_exit": _exit(h, 3),
        "sync_aggregate": block.message.body.sync_aggregate,
        "message": t.SyncCommitteeMessage(slot=state.slot - 1, beacon_block_root=b"\x05" * 32,
                                          validator_index=6, signature=sig),
        "cap": cap,
        "signed_cap": t.SignedContributionAndProof(message=cap, signature=sig),
        "contribution": contribution,
    }
    rt = ref_types_for(ref_spec)
    ref_objs = {k: getattr(rt, type(v).__name__).decode(_encode(v)) for k, v in objs.items()}
    ref_state = rt.state_classes["altair"].decode(_encode(state))
    cache, ref_cache = PubkeyCache(device="cpu"), RefCache()
    cache.import_new(state)
    ref_cache.import_new(ref_state)
    return {"port": (state, objs, cache, spec, t), "ref": (ref_state, ref_objs, ref_cache, ref_spec, rt)}


SET_MAKERS = {
    "block_proposal_set": lambda m, st, o, c, sp, t: m.block_proposal_set(st, o["signed_block"], c.get, sp),
    "randao_set": lambda m, st, o, c, sp, t: m.randao_set(st, o["block"], c.get, sp),
    "block_header_set": lambda m, st, o, c, sp, t: m.block_header_set(st, o["signed_header"], c.get, sp),
    "proposer_slashing_sets": lambda m, st, o, c, sp, t: m.proposer_slashing_sets(
        st, o["proposer_slashing"], c.get, sp),
    "indexed_attestation_set": lambda m, st, o, c, sp, t: m.indexed_attestation_set(
        st, o["indexed"], c.get, sp),
    "attester_slashing_sets": lambda m, st, o, c, sp, t: m.attester_slashing_sets(
        st, o["attester_slashing"], c.get, sp),
    "deposit_set": lambda m, st, o, c, sp, t: m.deposit_set(o["deposit_data"], sp),
    "voluntary_exit_set": lambda m, st, o, c, sp, t: m.voluntary_exit_set(st, o["signed_exit"], c.get, sp),
    "sync_aggregate_set": lambda m, st, o, c, sp, t: m.sync_aggregate_set(
        st, o["sync_aggregate"], st.slot, b"\x08" * 32, c.get_by_bytes, sp),
    "sync_committee_message_set": lambda m, st, o, c, sp, t: m.sync_committee_message_set(
        st, o["message"], c.get, sp),
    "sync_selection_proof_set": lambda m, st, o, c, sp, t: m.sync_selection_proof_set(
        st, o["cap"], c.get, sp, t),
    "signed_contribution_and_proof_set": lambda m, st, o, c, sp, t: m.signed_contribution_and_proof_set(
        st, o["signed_cap"], c.get, sp),
    "sync_contribution_set": lambda m, st, o, c, sp, t: m.sync_contribution_set(
        st, o["contribution"], [c.get(i) for i in (0, 5, 11)], sp),
}


def _set_bytes(sets):
    sets = sets if isinstance(sets, list) else [sets]
    return [(s.message, [p.to_bytes() for p in s.pubkeys], s.signature.to_bytes()) for s in sets]


@pytest.mark.parametrize("maker", sorted(SET_MAKERS))
def test_signature_set_equals_reference(set_inputs, maker):
    port = SET_MAKERS[maker](sigsets, *set_inputs["port"])
    ref = SET_MAKERS[maker](ref_sigsets, *set_inputs["ref"])
    assert _set_bytes(port) == _set_bytes(ref)
    assert all(len(m) == 32 for m, _, _ in _set_bytes(port))


def test_empty_sync_aggregate_sets_equal_reference(set_inputs):
    """No participants: the infinity signature gives no set, another
    signature the same error in both."""
    state, objs, cache, spec, t = set_inputs["port"]
    ref_state, ref_objs, ref_cache, ref_spec, rt = set_inputs["ref"]
    for sig in (bls.INFINITY_SIGNATURE_BYTES, objs["message"].signature):
        agg = t.SyncAggregate(sync_committee_bits=[False] * spec.SYNC_COMMITTEE_SIZE, sync_committee_signature=sig)
        ref_agg = rt.SyncAggregate.decode(_encode(agg))
        outs = []
        for m, st, a, c, sp, err in ((sigsets, state, agg, cache, spec, sigsets.SignatureSetError),
                                     (ref_sigsets, ref_state, ref_agg, ref_cache, ref_spec,
                                      ref_sigsets.SignatureSetError)):
            try:
                outs.append(m.sync_aggregate_set(st, a, st.slot, b"\x08" * 32, c.get_by_bytes, sp))
            except err as e:
                outs.append(str(e))
        assert outs[0] == outs[1] and (outs[0] is None) == (sig == bls.INFINITY_SIGNATURE_BYTES)


# --------------------------------------------------------------- strategies


def _tampered_block(h):
    """The next block with the first pending attestation's signature made
    over another message: decodable, in the subgroup, wrong."""
    atts = list(h.pending_attestations)
    atts[0] = atts[0].copy()
    atts[0].signature = h.keypairs[0].sk.sign(b"wrong message").to_bytes()
    return h.produce_block(h.state.slot + 1, atts)


def _spy(monkeypatch, module):
    calls = []
    real = module.verify_signature_sets

    def spy(sets, **kw):
        ok = real(sets, **kw)
        calls.append((len(sets), ok))
        return ok

    monkeypatch.setattr(module, "verify_signature_sets", spy)
    return calls


@pytest.mark.parametrize("strategy", ["verify_bulk", "verify_individual"])
def test_strategies_reject_the_tampered_attestation_like_reference(chains, strategy, monkeypatch):
    """VERIFY_BULK fails its one batch; VERIFY_INDIVIDUAL raises at the
    offending attestation, after the proposal's and RANDAO's calls -- the
    same calls and verdicts as the reference's, both on "ref"."""
    ref_spec, h = chains["phase0"]
    block = _tampered_block(h)
    pre = process_slots(h.state.copy(), block.message.slot, h.spec, device="cpu")
    rt = ref_types_for(ref_spec)
    ref_state = rt.state_classes["phase0"].decode(_encode(pre))
    ref_block = rt.signed_block_classes["phase0"].decode(_encode(block))
    ref_calls, calls = _spy(monkeypatch, ref_bls), _spy(monkeypatch, bls)
    with pytest.raises(RefError) as ref_err:
        ref_per_block(ref_state, ref_block, ref_spec, RefStrategy(strategy), RefCache(), backend="ref")
    with pytest.raises(BlockProcessingError) as err:
        per_block_processing(pre, block, h.spec, BlockSignatureStrategy(strategy), PubkeyCache(device="cpu"),
                             backend="ref", device="cpu")
    assert str(err.value) == str(ref_err.value)
    assert calls == ref_calls
    assert calls == ([(3, False)] if strategy == "verify_bulk" else [(1, True), (1, True), (1, False)])


def test_no_verification_builds_no_set(chains, monkeypatch):
    ref_spec, h = chains["altair"]
    block = _tampered_block(h)

    def refuse(data):
        raise AssertionError("a signature was decoded")

    monkeypatch.setattr(api.Signature, "from_bytes", staticmethod(refuse))
    pre = process_slots(h.state.copy(), block.message.slot, h.spec, device="cpu")
    coll = SignatureCollector(NOV, device="cpu")
    per_block_processing(pre, block, h.spec, NOV, PubkeyCache(device="cpu"), collector=coll, device="cpu")
    coll.finish()
    assert coll.sets == []
    with pytest.raises(AssertionError, match="decoded"):
        per_block_processing(process_slots(h.state.copy(), block.message.slot, h.spec, device="cpu"),
                             block, h.spec, BlockSignatureStrategy.VERIFY_BULK, PubkeyCache(device="cpu"),
                             backend="fake", device="cpu")


def test_block_constants_equal_the_spec_helpers(chains):
    from lighthouse_tpu.state_processing.per_block import (
        get_base_reward_per_increment as ref_reward_per_increment)
    from lighthouse_tpu_torch.state_processing.helpers import (
        CommitteeCache, get_beacon_proposer_index, get_total_active_balance)

    ref_spec, h = chains["altair"]
    state = process_slots(h.state.copy(), h.state.slot + 1, h.spec, device="cpu")
    consts = per_block.BlockConstants(state, h.spec, CommitteeCache(state, 0, h.spec))
    assert consts.proposer_index == get_beacon_proposer_index(state, h.spec)
    assert consts.total_active_balance == get_total_active_balance(state, h.spec)
    ref_state = ref_types_for(ref_spec).state_classes["altair"].decode(_encode(state))
    assert consts.base_reward_per_increment == ref_reward_per_increment(ref_state, ref_spec)
    # another epoch's committees: built on first use, kept, equal to a fresh cache's
    later = consts.committee_cache(1)
    assert consts.committee_cache(1) is later and consts.committee_cache(0) is consts.committee_cache(0)
    slot = h.spec.SLOTS_PER_EPOCH + 3
    assert later.get_beacon_committee(slot, 0) == CommitteeCache(state, 1, h.spec).get_beacon_committee(slot, 0)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_previous_epoch_attestations_equal_reference(chains, fork, monkeypatch):
    """The first block of epoch 1 carrying slot 2's attestation twice:
    the previous epoch's committees are built once for the block, and the
    post-state equals the reference's."""
    ref_spec, h = chains[fork]
    block = h.produce_block(h.spec.SLOTS_PER_EPOCH, list(h.pending_attestations) * 2)
    built = []

    class Counting(per_block.CommitteeCache):
        def __init__(self, state, epoch, spec):
            built.append(epoch)
            super().__init__(state, epoch, spec)

    monkeypatch.setattr(per_block, "CommitteeCache", Counting)
    _apply_both(ref_spec, h, block)
    assert sorted(built) == [0, 1]


# ------------------------------------------------------------------ genesis


def test_genesis_from_eth1_cache_equals_reference(monkeypatch):
    """Deposit genesis at a small trigger count: incremental proofs, an
    invalid signature skipped, a top-up merged, the trigger, a block too
    early or too small skipped; the port's default backend is "ref" here,
    as the reference's is."""
    kw = {"MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": 4}
    ref_spec, spec = ref_minimal_spec(ALTAIR_FORK_EPOCH=PHASE0, **kw), minimal_spec(ALTAIR_FORK_EPOCH=PHASE0, **kw)
    t = types_for(spec)
    datas = [_deposit_data(t, spec, bls.SecretKey(1000 + i), spec.MAX_EFFECTIVE_BALANCE) for i in range(4)]
    bad = _deposit_data(t, spec, bls.SecretKey(4242), spec.MAX_EFFECTIVE_BALANCE)
    bad.signature = datas[0].signature
    topup = _deposit_data(t, spec, bls.SecretKey(1000), spec.EFFECTIVE_BALANCE_INCREMENT)
    datas += [bad, topup]
    when = spec.MIN_GENESIS_TIME
    blocks = [SimpleNamespace(hash=b"\x20" * 32, timestamp=when, deposit_count=3),
              SimpleNamespace(hash=b"\x21" * 32, timestamp=0, deposit_count=6),
              SimpleNamespace(hash=b"\x22" * 32, timestamp=when, deposit_count=6)]
    cache = SimpleNamespace(blocks=blocks, deposit_data=datas)
    monkeypatch.setattr(api, "default_backend", lambda: "ref")
    state = genesis.genesis_from_eth1_cache(cache, spec, device="cpu")
    rt = ref_types_for(ref_spec)
    ref_cache = SimpleNamespace(blocks=blocks, deposit_data=[rt.DepositData.decode(_encode(d)) for d in datas])
    ref_state = ref_genesis.genesis_from_eth1_cache(ref_cache, ref_spec)
    assert _encode(state) == _encode(ref_state)
    assert len(state.validators) == 4 and state.eth1_deposit_index == 6
    assert bytes(state.eth1_data.block_hash) == b"\x22" * 32
    assert genesis.is_valid_genesis_state(state, spec)
    deposits = genesis.genesis_deposits(datas[:2], spec)
    assert [_encode(d) for d in deposits] == [
        _encode(d) for d in ref_genesis.genesis_deposits(ref_cache.deposit_data[:2], ref_spec)]


@pytest.mark.parametrize("altair_epoch", [PHASE0, 0], ids=["phase0", "altair"])
def test_interop_and_empty_genesis_equal_reference(altair_epoch):
    ref_spec, spec = _specs(altair_epoch)
    keys = [kp.pk.to_bytes() for kp in bls.interop_keypairs(8)]
    assert _encode(genesis.interop_genesis_state(keys, 7, spec)) == _encode(
        ref_genesis.interop_genesis_state(keys, 7, ref_spec))
    args = (b"\x33" * 32, 1_000, 5, b"\x44" * 32)
    st, fork = genesis.empty_genesis_state(*args, spec)
    ref_st, ref_fork = ref_genesis.empty_genesis_state(*args, ref_spec)
    assert _encode(st) == _encode(ref_st) and fork == ref_fork
