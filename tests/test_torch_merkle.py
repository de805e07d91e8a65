"""The port's Merkle-proof plane (`lighthouse_tpu_torch/ops/merkle_proof.py`)
against the reference's (`lighthouse_tpu/ops/merkle_proof.py`), on the CPU.

The plain version of the SHA-256 fold kernel and `batch_merkle_roots`
(device="cpu") are held byte for byte against the reference's hashlib
oracle `fold_branches_host` and, once, against the reference's own jitted
JAX fold on 8 lanes: depths 1, 3, 6, 17 and 33, lane counts 1, 7 and 64,
leaves and siblings whose words have their high bit set (an arithmetic
shift on int32 would show there), both direction polarities, and the
committed `state_proof` vectors. The kernel's constants are read out of
`csrc/sha256_fold.cu` and checked against FIPS 180-4 and the padding
block's schedule. Inputs are made from a seed with numpy.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import merkle_proof as rmp
from lighthouse_tpu_torch.common import device_attribution as pattr
from lighthouse_tpu_torch.device_plane import GUARD, INJECTOR
from lighthouse_tpu_torch.device_plane import executor as pexec
from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.ops import merkle_proof as pmp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors", "merkle_proof", "state_proof")
SOURCE = os.path.join(cuda_build.CSRC, "sha256_fold.cu")


@pytest.fixture(autouse=True)
def clean_guard():
    GUARD.reset()
    INJECTOR.reset()
    yield
    GUARD.reset()
    INJECTOR.reset()


def _queries(n: int, depth: int, seed: int, polarity: str = "random") -> list:
    """n (leaf, branch, gindex) queries at `depth` from a seed: random
    bytes, every third leaf and sibling with each word's high bit set;
    paths all left ("left"), all right ("right") or random."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        leaf = bytearray(rng.bytes(32))
        branch = [bytearray(rng.bytes(32)) for _ in range(depth)]
        if i % 3 == 0:
            for chunk in [leaf] + branch:
                for k in range(0, 32, 4):
                    chunk[k] |= 0x80
        path = {"left": 0, "right": (1 << depth) - 1,
                "random": int.from_bytes(rng.bytes(8), "big") % (1 << depth)}[polarity]
        out.append((bytes(leaf), [bytes(b) for b in branch], (1 << depth) | path))
    return out


def _tensors(queries, depth):
    return tuple(torch.from_numpy(a) for a in pmp.pack_queries(queries, depth))


def _roots(words: torch.Tensor) -> list:
    return pmp._chunks(words.numpy().view(np.uint32))


@pytest.mark.parametrize("depth", [1, 3, 6, 17, 33])
def test_plain_fold_matches_the_hashlib_oracle(depth):
    """One plain fold over 72 lanes: 1 all-left, 7 all-right and 64 random
    paths, a third of them with high-bit words."""
    queries = (_queries(1, depth, depth, "left") + _queries(7, depth, depth + 100, "right")
               + _queries(64, depth, depth + 200))
    got = _roots(pmp.fold_branches_plain(*_tensors(queries, depth)))
    assert got == rmp.fold_branches_host(queries) == pmp.fold_branches_host(queries)


@pytest.mark.parametrize("lanes", [1, 7, 64])
def test_batch_merkle_roots_matches_the_oracle(lanes):
    """Mixed depths in one call, query order kept, each depth a guarded
    dispatch with the reference's bucket in its label."""
    queries = _queries(lanes, 1, lanes) + _queries(lanes, 3, lanes + 1, "right")
    order = np.random.default_rng(lanes).permutation(len(queries))
    queries = [queries[i] for i in order]
    assert pmp.batch_merkle_roots(queries, consumer="bench", device="cpu") \
        == rmp.fold_branches_host(queries)
    bucket = max(8, 1 << (lanes - 1).bit_length())
    assert GUARD.stats()["dispatches"] == 2
    assert set(GUARD.breaker.snapshot()) == {f"merkle_proof/d1x{bucket}",
                                             f"merkle_proof/d3x{bucket}"}


def test_reference_jax_fold_agrees_word_for_word():
    """The reference's own jitted fold (`_get_jitted(2)`) on 8 lanes: the
    same words as the port's plain version."""
    queries = _queries(4, 2, 7, "left") + _queries(4, 2, 8, "right")
    leaves, siblings, dirbits = pmp.pack_queries(queries, 2)
    ref = np.asarray(rmp._get_jitted(2)(leaves.view(np.uint32), siblings.view(np.uint32),
                                        dirbits.astype(np.uint32)))
    port = pmp.fold_branches_plain(*(torch.from_numpy(a) for a in (leaves, siblings, dirbits)))
    assert np.array_equal(port.numpy().view(np.uint32), ref)


def _state_proof_cases():
    out = []
    for name in sorted(os.listdir(VECTORS)):
        with open(os.path.join(VECTORS, name)) as f:
            case = json.load(f)
        i = case["input"]
        unhex = bytes.fromhex
        out.append((name, (unhex(i["leaf"][2:]), [unhex(b[2:]) for b in i["branch"]], i["gindex"]),
                    unhex(i["state_root"][2:]), case["output"]))
    return out


def test_committed_state_proof_vectors():
    cases = _state_proof_cases()
    assert len(cases) == 6
    queries = [q for _, q, _, _ in cases]
    roots = [r for _, _, r, _ in cases]
    assert pmp.batch_merkle_roots(queries, consumer="bench", device="cpu") \
        == rmp.fold_branches_host(queries)
    verdicts = pmp.batch_verify_branches(queries, roots, consumer="bench", device="cpu")
    assert verdicts == [want for *_, want in cases]
    assert verdicts.count(True) == 3 and verdicts.count(False) == 3


def test_branch_length_mismatch_raises_the_references_error():
    queries = _queries(2, 3, 5)
    queries[1] = (queries[1][0], queries[1][1][:2], queries[1][2])
    msgs = []
    for mod, kw in ((rmp, {}), (pmp, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.batch_merkle_roots(queries, consumer="bench", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == f"query 1: branch length 2 does not match gindex {queries[1][2]} depth"
    assert GUARD.stats()["dispatches"] == 0


def test_depth_zero_and_empty():
    """Depth 0 is answered on the host, the root being the leaf, with no
    dispatch; an empty list is empty."""
    leaf = bytes(range(32))
    queries = [(leaf, [], 1), (bytearray(leaf[::-1]), [], 1)]
    for mod in (rmp, pmp):
        assert mod.batch_merkle_roots(queries, consumer="bench") == [leaf, leaf[::-1]]
        assert mod.batch_merkle_roots([], consumer="bench") == []
        assert mod.batch_verify_branches(queries, [leaf, leaf], consumer="bench") == [True, False]
    assert GUARD.stats()["dispatches"] == 0


@pytest.mark.parametrize("kind, exc", [("stall", pexec.DeviceStallInjected),
                                       ("error", pexec.DeviceErrorInjected)])
def test_guard_faults_reach_the_caller(kind, exc):
    """No fallback tier: an injected fault raises its class, counted on the
    merkle_proof plane against the group's bucket."""
    GUARD.configure(watchdog=False)
    INJECTOR.arm(kind, "merkle_proof", rate=1.0, seed=0)
    queries = _queries(3, 2, 11)
    with pytest.raises(exc):
        pmp.batch_merkle_roots(queries, consumer="bench", device="cpu")
    st = GUARD.stats()
    assert st["faults"] == {f"merkle_proof:{kind}": 1}
    assert st["dispatches"] == 1
    assert GUARD.breaker.snapshot() == {"merkle_proof/d2x8": "closed"}  # 1 failure of 3


def test_flip_leaves_the_roots_alone():
    GUARD.configure(watchdog=False)
    INJECTOR.arm("flip", "merkle_proof", rate=1.0, seed=0)
    queries = _queries(3, 2, 12)
    roots = rmp.fold_branches_host(queries)
    assert pmp.batch_verify_branches(queries, roots, consumer="bench", device="cpu") == [True] * 3


def test_attribution_on_the_merkle_plane():
    queries = _queries(9, 2, 13)
    before = dict(pattr._BATCHES.children())
    amort = dict(pattr.amortized_totals())
    pmp.batch_merkle_roots(queries, consumer="light_client", device="cpu")
    key = ("light_client", "merkle_proof", "16")
    assert pattr._BATCHES.children()[key].value - (before[key].value if key in before else 0) == 1
    akey = ("light_client", "merkle_proof")
    assert pattr.amortized_totals()[akey] - amort.get(akey, 0.0) == pytest.approx(
        pattr.FIXED_DEVICE_COST_MS)
    with pytest.raises(ValueError, match="unknown device-plane consumer"):
        pmp.batch_merkle_roots(queries, consumer="not_a_consumer", device="cpu")
    assert GUARD.stats()["dispatches"] == 1


def _c_array(name: str) -> list:
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"__constant__ uint32_t " + name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
    return [int(x, 16) for x in re.findall(r"0x[0-9a-fA-F]+", body)]


def test_kernel_constants():
    """The kernel's round constants and initial state are FIPS 180-4's (the
    reference's), and PAD_KW is K + W of the padding block's schedule."""
    assert _c_array("K") == list(pmp._SHA_K) == list(rmp._SHA_K)
    assert _c_array("IV") == list(pmp._SHA_IV) == list(rmp._SHA_IV)
    assert _c_array("PAD_KW") == list(pmp.pad_round_words())
    # the padding block's compression alone equals hashlib's second block:
    # sha256 of 64 zero bytes is two compressions from the initial state
    iv = [torch.tensor([x], dtype=torch.int64) for x in pmp._SHA_IV]
    zero = [torch.zeros(1, dtype=torch.int64)] * 16
    st = pmp._compress_plain(pmp._compress_plain(iv, zero, pad=False), None, pad=True)
    import hashlib

    want = np.frombuffer(hashlib.sha256(bytes(64)).digest(), dtype=">u4")
    assert [int(t) for t in st] == [int(x) for x in want]


def test_bound_counts():
    assert pmp.level_ops() == 3_664 and pmp.level_instructions() == 2_304
    assert pmp.fold_ops(16_384, 6) == 16_384 * 6 * 2_304
    assert pmp.fold_ops(16_384, 6, pmp.level_ops) == 16_384 * 6 * 3_664
    assert pmp.fold_bytes(16_384, 6) == 16_384 * 280
    with open(SOURCE) as f:
        text = f.read()
    assert "A level is 3,664" in text and "and 2,304 at Hopper's" in text


def test_proof_queries_are_the_light_client_fixtures():
    """chip_smoke.py's depth-6 queries are bench_lcserve.py's lcproof ones."""
    from lighthouse_tpu.bench_lcserve import _proof_queries
    from lighthouse_tpu_torch.testing import proof_queries

    assert proof_queries(33, 6) == _proof_queries(33, 6)
