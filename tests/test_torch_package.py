"""Package rules of the port (lighthouse_tpu_torch) and of chip_smoke.py:

* neither imports `jax` or anything of `lighthouse_tpu` (the port keeps its
  own copies of what it needs) and neither reads environment knobs;
* every kernel wrapper raises when a CPU tensor asks for its kernel, and
  device="cuda" raises when no GPU is present: nothing falls back silently
  to the plain versions;
* chip_smoke.py exits non-zero, with no result line, without a GPU.
"""

import ast
import ctypes
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import api, gpu_backend
from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable
from lighthouse_tpu_torch.ops import cuda_build, curve_kernels, field as fd
from lighthouse_tpu_torch.da import cells as da_cells, erasure
from lighthouse_tpu_torch.da.domain import geometry
from lighthouse_tpu_torch.ops import final_exp, ladder, merkle_proof, miller, mma_probe, subgroup
from lighthouse_tpu_torch.ops import rfield, rs_extend
from lighthouse_tpu_torch.ops.slot_program import SlotProgram
from lighthouse_tpu_torch.slasher import device as slasher_device
from lighthouse_tpu_torch.state_processing import epoch_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lighthouse_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


SOURCES = _port_sources()


def _rel(path):
    return os.path.relpath(path, ROOT)


@pytest.mark.parametrize("path", SOURCES, ids=_rel)
def test_no_jax_and_no_reference_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    roots = {name.split(".")[0] for name in imported}
    assert not roots & {"jax", "jaxlib", "lighthouse_tpu"}, (_rel(path), sorted(roots))


@pytest.mark.parametrize("path", SOURCES, ids=_rel)
def test_no_environment_knobs(path):
    """One path, no LIGHTHOUSE_* style switches."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv"), _rel(path)


# the block plane and the chain runtime: their modules are in both scans above
BLOCK_MODULES = [
    "lighthouse_tpu_torch/beacon_chain/chain.py",
    "lighthouse_tpu_torch/beacon_chain/data_availability_checker.py",
    "lighthouse_tpu_torch/common/logging.py",
    "lighthouse_tpu_torch/fork_choice/fork_choice.py",
    "lighthouse_tpu_torch/light_client/producer.py",
    "lighthouse_tpu_torch/store/hot_cold.py",
    "lighthouse_tpu_torch/harness.py",
    "lighthouse_tpu_torch/eth1/deposit_tree.py",
    "lighthouse_tpu_torch/state_processing/genesis.py",
    "lighthouse_tpu_torch/state_processing/per_block.py",
    "lighthouse_tpu_torch/state_processing/pubkey_cache.py",
    "lighthouse_tpu_torch/state_processing/signature_sets.py",
]


def test_scans_cover_the_block_plane():
    assert set(BLOCK_MODULES) <= {_rel(p) for p in SOURCES}


# the node and its network layer: in both scans above too
NODE_MODULES = [
    "lighthouse_tpu_torch/common/slot_clock.py",
    "lighthouse_tpu_torch/node.py",
] + [f"lighthouse_tpu_torch/network/{m}.py" for m in (
    "__init__", "snappy_codec", "gossip", "rpc", "shedding", "beacon_processor", "discovery",
    "subnet_service", "fault_injection", "sync", "socket_net")]


def test_scans_cover_the_node():
    assert set(NODE_MODULES) <= {_rel(p) for p in SOURCES}
    assert os.path.exists(os.path.join(PKG, "native", "snappy.c"))


def _block_entry_points():
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.beacon_chain.data_availability_checker import DataAvailabilityChecker
    from lighthouse_tpu_torch.harness import Harness
    from lighthouse_tpu_torch.light_client import LightClientUpdateProducer
    from lighthouse_tpu_torch.node import BeaconNode
    from lighthouse_tpu_torch.state_processing import genesis, per_block, pubkey_cache
    from lighthouse_tpu_torch.store import HotColdDB

    return {
        "Harness": Harness.__init__, "Harness.from_genesis": Harness.from_genesis,
        "PubkeyCache": pubkey_cache.PubkeyCache.__init__,
        "SignatureCollector": per_block.SignatureCollector.__init__,
        "per_block_processing": per_block.per_block_processing,
        "process_deposit": per_block.process_deposit, "apply_deposit": per_block.apply_deposit,
        "initialize_beacon_state_from_eth1": genesis.initialize_beacon_state_from_eth1,
        "genesis_from_eth1_cache": genesis.genesis_from_eth1_cache,
        "chain_harness": T.chain_harness,
        "BeaconChain": BeaconChain.__init__, "BeaconChain.from_checkpoint": BeaconChain.from_checkpoint,
        "DataAvailabilityChecker": DataAvailabilityChecker.__init__,
        "LightClientUpdateProducer": LightClientUpdateProducer.__init__, "HotColdDB": HotColdDB.__init__,
        "BeaconNode": BeaconNode.__init__,
    }


@pytest.mark.parametrize("name", sorted(_block_entry_points()))
def test_block_entry_points_default_to_the_card(name):
    import inspect

    params = inspect.signature(_block_entry_points()[name]).parameters
    assert params["device"].default == "cuda"
    if "backend" in params and name.startswith(("Harness", "chain", "BeaconChain", "BeaconNode",
                                                "DataAvailability")):
        assert params["backend"].default == "gpu"


def test_every_kernel_has_a_source_and_a_counter():
    for source, entries in cuda_build.SOURCES.items():
        assert os.path.exists(os.path.join(cuda_build.CSRC, f"{source}.cu"))
        assert all(e.startswith("lh_") for e in entries)
    for name in os.listdir(cuda_build.CSRC):  # every header a source includes is there
        with open(os.path.join(cuda_build.CSRC, name)) as f:
            for header in re.findall(r'#include "([^"]+)"', f.read()):
                assert os.path.exists(os.path.join(cuda_build.CSRC, header)), (name, header)
    assert set(cuda_build.LAUNCHES) == {
        "ladder_g1", "ladder_g2", "miller", "fold_final_exp",
        "lane_sum_g1", "lane_sum_g2", "to_affine_g1", "to_affine_g2",
        "jacobian_to_affine_g1", "jacobian_to_affine_g2", "ladder_g1_chain", "ladder_g2_chain", "ladder_g1_w2", "ladder_g2_w2",
        "pair_final_exp", "mma_probe_i8", "mma_probe_bf16", "subgroup_g2", "sha256_fold",
        "rs_extend", "epoch_rewards", "slasher_update",
    }


def _point(w, B):
    return tuple(torch.zeros((w, fd.NW, B), dtype=torch.int32) for _ in range(3))


def _digits(B):
    return torch.zeros((17, B), dtype=torch.int32), torch.zeros((17, B), dtype=torch.int32)


def _bits(B):
    return torch.zeros((64, B), dtype=torch.int32)


WRAPPERS = {
    "ladder_g1": lambda: ladder.ladder(_point(1, 4), *_digits(4), require_kernel=True),
    "ladder_g2": lambda: ladder.ladder(_point(2, 4), *_digits(4), require_kernel=True),
    "miller": lambda: miller.miller_loop(
        _point(1, 4)[:2], _point(2, 4)[:2], torch.ones(4, dtype=torch.bool), require_kernel=True
    ),
    "fold_final_exp": lambda: final_exp.fold_final_exp(
        torch.zeros((12, fd.NW, 4), dtype=torch.int32), require_kernel=True
    ),
    "lane_sum_g1": lambda: curve_kernels.lane_sum(_point(1, 4), 2, require_kernel=True),
    "lane_sum_g2": lambda: curve_kernels.lane_sum(_point(2, 4), 2, require_kernel=True),
    "to_affine_g1": lambda: curve_kernels.to_affine(_point(1, 4), require_kernel=True),
    "to_affine_g2": lambda: curve_kernels.to_affine(_point(2, 4), require_kernel=True),
    "jacobian_to_affine_g1": lambda: curve_kernels.jacobian_to_affine(_point(1, 4), require_kernel=True),
    "jacobian_to_affine_g2": lambda: curve_kernels.jacobian_to_affine(_point(2, 4), require_kernel=True),
    "ladder_g1_chain": lambda: ladder.ladder(_point(1, 4), _bits(4), form="chain", require_kernel=True),
    "ladder_g2_chain": lambda: ladder.ladder(_point(2, 4), _bits(4), form="chain", require_kernel=True),
    "ladder_g1_w2": lambda: ladder.ladder(_point(1, 4), _bits(4), form="w2", require_kernel=True),
    "ladder_g2_w2": lambda: ladder.ladder(_point(2, 4), _bits(4), form="w2", require_kernel=True),
    "pair_final_exp": lambda: final_exp.pair_final_exp(
        torch.zeros((12, fd.NW, 4), dtype=torch.int32), require_kernel=True
    ),
    "mma_probe_i8": lambda: mma_probe.contract(
        *mma_probe.operands(*mma_probe.probe_inputs(), "i8", "cpu"), "i8", require_kernel=True
    ),
    "mma_probe_bf16": lambda: mma_probe.contract(
        *mma_probe.operands(*mma_probe.probe_inputs(), "bf16", "cpu"), "bf16", require_kernel=True
    ),
    "subgroup_g2": lambda: subgroup.g2_in_subgroup(
        *_point(2, 4)[:2], torch.ones(4, dtype=torch.bool), require_kernel=True
    ),
    "sha256_fold": lambda: merkle_proof.fold_branches(
        torch.zeros((4, 8), dtype=torch.int32), torch.zeros((4, 2, 8), dtype=torch.int32),
        torch.zeros((4, 2), dtype=torch.int32), require_kernel=True
    ),
    "rs_extend": lambda: rs_extend.eval_poly_batch(
        torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32),
        require_kernel=True
    ),
    "epoch_rewards": lambda: epoch_kernel.rewards(
        torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.uint8),
        *[torch.zeros(4, dtype=torch.int64)] * 2, *[torch.ones(4, dtype=torch.bool)] * 3,
        (1, 1, 1, 0, 4, 16, 4), require_kernel=True
    ),
    "slasher_update": lambda: slasher_device.batch_update(
        torch.zeros((4, 8), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int32),
        *[torch.zeros(2, dtype=torch.int32)] * 3, torch.ones(2, dtype=torch.bool),
        device="cpu", require_kernel=True
    ),
}


def test_every_counter_has_a_wrapper_check():
    assert set(WRAPPERS) == set(cuda_build.LAUNCHES)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrapper_refuses_cpu_tensor_for_kernel(kernel):
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel was requested for a CPU tensor"):
        WRAPPERS[kernel]()
    assert cuda_build.LAUNCHES == before


@pytest.mark.parametrize(
    "t, shape, why",
    [
        (torch.zeros((1, 12, 4), dtype=torch.int32), (1, 12, 4), "CUDA tensors"),
        (np.zeros((1, 12, 4), np.int32), (1, 12, 4), "expected a tensor"),
    ],
    ids=["cpu_tensor", "numpy"],
)
def test_check_refuses_what_a_kernel_cannot_take(t, shape, why):
    with pytest.raises((ValueError, TypeError), match=why):
        cuda_build.check(t, "x", shape)


def test_plain_path_is_taken_for_cpu_tensors_and_launches_nothing():
    before = dict(cuda_build.LAUNCHES)
    out = curve_kernels.to_affine(_point(1, 2))
    assert out[2].tolist() == [True, True]  # Z = 0: the identity
    assert cuda_build.LAUNCHES == before


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")


def test_cuda_device_without_gpu_raises():
    _needs_no_gpu()
    sets = T.flat_sets(T.validator_pubkeys(2), 1, max_keys=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.verify_signature_sets(sets, seed=0, device="cuda")


@pytest.mark.parametrize(
    "call",
    [
        lambda sets: gpu_backend.check_signature_subgroups([s.signature for s in sets], device="cuda"),
        lambda sets: api.verify_signature_set_batches([sets], seed=0, device="cuda"),
        lambda sets: merkle_proof.batch_merkle_roots(
            [(bytes(32), [bytes(32)], 2)], consumer="bench", device="cuda"),
        lambda sets: SlotProgram(seed=0).add_signatures(sets, "oppool").add_merkle(
            [(bytes(32), [bytes(32)], 2)], [bytes(32)]).run(backend="gpu", device="cuda"),
        lambda sets: erasure.extend_blobs([bytes(256)], geometry(8, 4), device="cuda"),
        lambda sets: da_cells.verify_cell_proof_batch(
            [(bytes([0xC0]) + bytes(47), 0, bytes(128), bytes([0xC0]) + bytes(47))],
            geometry(8, 4), device="cuda"),
    ],
    ids=["check_signature_subgroups", "verify_signature_set_batches", "batch_merkle_roots",
         "SlotProgram.run", "extend_blobs", "verify_cell_proof_batch"],
)
def test_new_entry_points_without_gpu_raise(call, monkeypatch):
    """Each raises before any plain version runs: no fold, no plain
    product."""
    _needs_no_gpu()
    sets = T.flat_sets(T.validator_pubkeys(2), 1, max_keys=1, seed=0)
    ran = []
    monkeypatch.setattr(merkle_proof, "fold_branches_plain", lambda *a: ran.append("fold"))
    products = fd.FP_PRODUCTS, rfield.FR_PRODUCTS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(sets)
    assert ran == [] and (fd.FP_PRODUCTS, rfield.FR_PRODUCTS) == products


def _altair_state(epoch):
    from lighthouse_tpu_torch.types.containers import types_for
    from lighthouse_tpu_torch.types.spec import minimal_spec

    spec = minimal_spec(ALTAIR_FORK_EPOCH=0)
    state = types_for(spec).BeaconStateAltair()
    state.slot = (epoch + 1) * spec.SLOTS_PER_EPOCH - 1  # the epoch's last slot
    return state, spec


@pytest.mark.parametrize(
    "call",
    [
        lambda: epoch_kernel.run_inactivity_and_rewards(*_altair_state(3), None),
        lambda: __import__("lighthouse_tpu_torch.state_processing.per_epoch",
                           fromlist=["process_epoch"]).process_epoch(*_altair_state(3)),
        lambda: __import__("lighthouse_tpu_torch.state_processing.per_slot",
                           fromlist=["process_slots"]).process_slots(
            _altair_state(3)[0], 4 * 8, _altair_state(3)[1]),
        lambda: slasher_device.batch_update(
            torch.zeros((4, 8), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int32),
            *[torch.zeros(2, dtype=torch.int32)] * 3, torch.ones(2, dtype=torch.bool)),
    ],
    ids=["run_inactivity_and_rewards", "process_epoch", "process_slots", "batch_update"],
)
def test_epoch_and_slasher_entry_points_default_to_the_card(call, monkeypatch):
    """Without a GPU, the default device raises before any plain version
    runs."""
    _needs_no_gpu()
    ran = []
    monkeypatch.setattr(epoch_kernel, "rewards_plain", lambda *a: ran.append("epoch"))
    monkeypatch.setattr(slasher_device, "batch_update_plain", lambda *a: ran.append("slasher"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert ran == []


def test_beacon_node_without_gpu_raises():
    """The node's default device raises before any chain is built."""
    _needs_no_gpu()
    from lighthouse_tpu_torch.node import BeaconNode

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BeaconNode("n", *_altair_state(0))


def test_cuda_table_without_gpu_raises():
    _needs_no_gpu()
    table = DevicePubkeyTable("cuda")
    table.append(T.validator_pubkeys(1))
    with pytest.raises((RuntimeError, AssertionError)):
        table.rows()


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    _needs_no_gpu()
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


ENTRIES = [(src, fn) for src, fns in sorted(cuda_build.SOURCES.items()) for fn in sorted(fns)]


@pytest.mark.parametrize("source, entry", ENTRIES, ids=[e for _, e in ENTRIES])
def test_c_entry_matches_its_ctypes_signature(source, entry):
    """Every entry `cuda_build` binds is exported from its source with a
    plain C interface and as many parameters as its argtypes: pointers
    (void*) and ints, the stream last."""
    with open(os.path.join(cuda_build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, f"{entry} is not exported from {source}.cu"
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = cuda_build.SOURCES[source][entry]
    assert len(params) == len(argtypes)
    for param, t in zip(params, argtypes):
        assert param.startswith("int ") if t is ctypes.c_int else "void*" in param, (param, t)
    assert params[-1] == "void* stream"


@pytest.mark.parametrize("stack", [True, False], ids=["stack_frame", "no_stack_frame"])
def test_ptxas_summary_reads_every_entry(stack):
    used = "Used 94 registers, used 0 barriers" + (", 2352 bytes cumulative stack size" if stack else "")
    used += ", 24576 bytes smem"
    text = (
        "ptxas info    : Compiling entry function '_Zk' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Zk\n"
        "    2352 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        f"ptxas info    : {used}, 400 bytes cmem[0]\n"
    )
    out = cuda_build.ptxas_summary(text)
    assert out["kernels"] == {
        "_Zk": {"registers": 94, "stack_bytes": 2352 if stack else 0, "shared_bytes": 24576}}
    assert (out["spill_store_bytes"], out["spill_load_bytes"]) == (8, 4)


def _includers(header):
    """The sources that include `header`, directly or through another
    header."""
    def includes(name):
        with open(os.path.join(cuda_build.CSRC, name)) as f:
            return re.findall(r'#include "([^"]+)"', f.read())

    found, todo = set(), [header]
    while todo:
        h = todo.pop()
        for name in os.listdir(cuda_build.CSRC):
            if h in includes(name) and name not in found:
                found.add(name)
                todo.append(name)
    return sorted(n[:-3] for n in found if n.endswith(".cu"))


HEADERS = sorted(n for n in os.listdir(cuda_build.CSRC) if n.endswith(".cuh"))


@pytest.mark.parametrize("header", HEADERS)
def test_every_header_makes_its_sources_stale(monkeypatch, tmp_path, header):
    """A library built before one of the headers its source includes
    (directly or through another header, the generated row tables among
    them) is rebuilt; one built after every file of csrc is not."""
    monkeypatch.setattr(cuda_build, "BUILD", str(tmp_path))
    sources = _includers(header)
    assert sources, f"{header}: no source includes it"
    newest = max(os.path.getmtime(os.path.join(cuda_build.CSRC, f))
                 for f in os.listdir(cuda_build.CSRC))
    for source in sources:
        so = cuda_build.lib_path(source)
        open(so, "w").close()
        os.utime(so, (newest + 10, newest + 10))
        assert not cuda_build._stale(source)
        os.utime(so, (os.path.getmtime(os.path.join(cuda_build.CSRC, header)) - 1,) * 2)
        assert cuda_build._stale(source), (header, source)

