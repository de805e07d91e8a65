"""Signature-set and Merkle-query generators for the port's tests and its
chip smoke run.

Large batches use the chained-addition form of `lighthouse_tpu/testing.py`
(`fast_sequential`): secret keys are small consecutive integers and every
point is the previous one plus a base point, so a batch costs one host
point addition per key or signature instead of a 255-bit scalar
multiplication.
"""

import hashlib

import numpy as np

from lighthouse_tpu_torch.bls.api import PublicKey, Signature, SignatureSet
from lighthouse_tpu_torch.bls.gpu_backend import _msg_affine
from lighthouse_tpu_torch.crypto.ref_curve import G1 as RG1
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2


def validator_pubkeys(n: int) -> list:
    """PublicKeys of validators 0..n-1, validator i with secret key i + 1."""
    out, acc = [], RG1.infinity
    for _ in range(n):
        acc = RG1.add(acc, RG1.generator)
        out.append(PublicKey(acc))
    return out


def message(tag: str, i: int, seed: int) -> bytes:
    return hashlib.sha256(f"{tag}/{seed}/{i}".encode()).digest()


def _h(msg: bytes):
    """H(msg) as a Jacobian point (through the backend's message memo)."""
    return RG2.from_affine(_msg_affine(msg))


def committee_sets(pubkeys, n_groups: int, per_group: int, seed: int = 0) -> list:
    """One message per committee g, signed by validators g*per_group ..
    (g+1)*per_group - 1 (secret key = index + 1), one single-key set each:
    the gossip attestation shape."""
    sets = []
    for g in range(n_groups):
        msg = message("committee", g, seed)
        h = _h(msg)
        first = g * per_group
        sig = RG2.mul_scalar(h, first + 1)
        for v in range(first, first + per_group):
            sets.append(SignatureSet(Signature(sig), [pubkeys[v]], msg))
            sig = RG2.add(sig, h)
    return sets


def flat_sets(pubkeys, n_sets: int, max_keys: int = 4, seed: int = 0) -> list:
    """n_sets sets with distinct messages and 1..max_keys keys each, drawn
    from `pubkeys` (untagged copies, so the batch takes the point path)."""
    rng = np.random.default_rng(seed)
    sets = []
    for i in range(n_sets):
        k = int(rng.integers(1, max_keys + 1))
        idx = [int(v) for v in rng.choice(len(pubkeys), size=k, replace=False)]
        msg = message("flat", i, seed)
        sig = RG2.mul_scalar(_h(msg), sum(v + 1 for v in idx))
        keys = [PublicKey(pubkeys[v].point) for v in idx]
        sets.append(SignatureSet(Signature(sig), keys, msg))
    return sets


def forge(sets, i: int) -> list:
    """A copy of `sets` whose set i carries its signature plus H(m): invalid
    for its keys whatever they are."""
    s = sets[i]
    bad = SignatureSet(Signature(RG2.add(s.signature.point, _h(s.message))), s.pubkeys, s.message)
    return sets[:i] + [bad] + sets[i + 1 :]


def proof_queries(n: int, depth: int) -> list:
    """n deterministic (leaf, branch, gindex) Merkle queries at `depth`:
    the light-client proof fixtures of `lighthouse_tpu/bench_lcserve.py`
    (`_proof_queries`), leaves and siblings hashed from their indices."""
    queries = []
    for i in range(n):
        leaf = hashlib.sha256(b"lcproof-leaf-%d" % i).digest()
        branch = [hashlib.sha256(b"lcproof-sib-%d-%d" % (i, d)).digest() for d in range(depth)]
        gindex = (1 << depth) + (i * 2654435761 % (1 << depth))
        queries.append((leaf, branch, gindex))
    return queries


# ------------------------------------------------------------ epoch plane


def epoch_state(spec, n: int, epoch: int, seed: int = 0, leak: bool = False):
    """An altair BeaconState of `n` validators at the last slot of `epoch`,
    its fields seeded from `seed` and shaped like mainnet's registry: 95 %
    active at 32 ETH or 17-31 ETH effective (above the ejection balance, so
    the registry pass ejects no one), 2 % pending activation (FAR_FUTURE
    epochs), 2 % exited, 1 % slashed (some withdrawable only far ahead, some
    at the slashings vector's midpoint); ~90 % full participation; a few
    inactivity scores. Pubkeys are placeholders: an epoch whose successor
    rotates the sync committees needs real keys, so `epoch` + 1 must not be
    a multiple of EPOCHS_PER_SYNC_COMMITTEE_PERIOD."""
    from lighthouse_tpu_torch.types.containers import types_for
    from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH

    if (epoch + 1) % spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        raise ValueError(f"epoch {epoch}: the next epoch rotates the sync committees")
    t = types_for(spec)
    rng = np.random.default_rng(seed)
    inc = spec.EFFECTIVE_BALANCE_INCREMENT
    status = rng.choice(4, n, p=[0.95, 0.02, 0.02, 0.01])  # active, pending, exited, slashed
    eff = np.where(rng.random(n) < 0.97, spec.MAX_EFFECTIVE_BALANCE, rng.integers(17, 32, n) * inc)
    exit_ep = epoch - rng.integers(1, 100, n)
    slash_exit = epoch + rng.integers(-2, 30, n)
    slash_wd = np.where(rng.random(n) < 0.2, epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2,
                        epoch + rng.integers(1, 8_192, n))
    validators = []
    zero32 = bytes(32)
    for i in range(n):
        st = int(status[i])
        if st == 0:
            fields = (False, 0, 0, FAR_FUTURE_EPOCH, FAR_FUTURE_EPOCH)
        elif st == 1:
            fields = (False, FAR_FUTURE_EPOCH if i % 2 else epoch - 3, FAR_FUTURE_EPOCH,
                      FAR_FUTURE_EPOCH, FAR_FUTURE_EPOCH)
        elif st == 2:
            fields = (False, 0, 0, int(exit_ep[i]), int(exit_ep[i]) + 256)
        else:
            fields = (True, 0, 0, int(slash_exit[i]), int(slash_wd[i]))
        validators.append(t.Validator(
            pubkey=i.to_bytes(48, "little"), withdrawal_credentials=zero32,
            effective_balance=int(eff[i]), slashed=fields[0],
            activation_eligibility_epoch=fields[1], activation_epoch=fields[2],
            exit_epoch=fields[3], withdrawable_epoch=fields[4]))
    balances = np.maximum(0, eff + rng.integers(-inc, inc, n))
    flags = np.where(rng.random((2, n)) < 0.9, 7, rng.integers(0, 8, (2, n)))
    scores = np.where(rng.random(n) < 0.1, rng.integers(0, 100, n), 0)
    if leak:
        scores = scores + rng.integers(0, 400, n)
    state = t.BeaconStateAltair(
        slot=(epoch + 1) * spec.SLOTS_PER_EPOCH - 1,
        validators=validators,
        balances=balances.tolist(),
        previous_epoch_participation=flags[0].tolist(),
        current_epoch_participation=flags[1].tolist(),
        inactivity_scores=scores.tolist(),
    )
    state.finalized_checkpoint.epoch = 0 if leak else epoch - 2
    state.slashings[0] = 64 * spec.MAX_EFFECTIVE_BALANCE
    state.block_roots = [hashlib.sha256(b"block/%d" % i).digest()
                         for i in range(spec.SLOTS_PER_HISTORICAL_ROOT)]
    return state


# ----------------------------------------------------------- slasher plane


def honest_prior(H: int):
    """(min_row, max_row): one validator's arrays after an honest history,
    a vote (e - 1, e) for every e in 1 .. H - 3, as int32 rows of H."""
    e = np.arange(H, dtype=np.int64)
    max_row = np.minimum(e + 1, H - 3)
    min_row = np.where(e <= H - 4, e + 1, np.iinfo(np.int32).max)
    return min_row.astype(np.int32), max_row.astype(np.int32)


def slasher_batches(V: int, H: int, slot_n: int, planted: int, seed: int = 0):
    """Two batches over an honest prior (`honest_prior`): one slot's
    `slot_n` attesters voting (H - 3, H - 2), with `planted` of them also
    voting (H // 2, H - 2), which surrounds their history; then one
    epoch's batch, every validator once voting (H - 2, H - 1), except the
    planted ones, who vote (H // 2 + H // 8, that + 1), which their planted
    vote surrounds. Returns ((v, s, t) of the slot batch, the slot batch's
    planted lanes, (v, s, t) of the epoch batch, its planted lanes), the
    lanes in a seeded order, int32."""
    rng = np.random.default_rng(seed)
    slot_v = rng.choice(V, slot_n, replace=False).astype(np.int32)
    marked = slot_v[:planted]
    a, b = H // 2, H // 2 + H // 8
    v = np.concatenate([slot_v, marked])
    s = np.concatenate([np.full(slot_n, H - 3), np.full(planted, a)]).astype(np.int32)
    t = np.full(slot_n + planted, H - 2, np.int32)
    perm = rng.permutation(len(v))
    slot = (v[perm], s[perm], t[perm])
    slot_planted = np.sort(np.nonzero(perm >= slot_n)[0])
    ev = rng.permutation(V).astype(np.int32)
    es = np.full(V, H - 2, np.int32)
    et = np.full(V, H - 1, np.int32)
    hit = np.isin(ev, marked)
    es[hit], et[hit] = b, b + 1
    return slot, slot_planted, (ev, es, et), np.nonzero(hit)[0]
