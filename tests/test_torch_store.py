"""The port's store (lighthouse_tpu_torch.store) against the JAX package's,
exactly, on the CPU.

One chain of 12 altair blocks from the port's `Harness` (device="cpu",
every signature the G2 generator: the store never checks one) is written to a `HotColdDB` of each package:
every column of the two `MemoryStore`s must hold the same bytes, before and
after the hot->cold migration, and a state rebuilt from a restore point by
replay must equal the state the chain had at that slot. `SqliteStore` round
trips through a fresh handle; the schema steps up and down as the
reference's do. Objects cross between the packages as SSZ bytes."""

import pytest

from lighthouse_tpu.store import HotColdDB as RefHotColdDB
from lighthouse_tpu.store import MemoryStore as RefMemoryStore
from lighthouse_tpu.store import schema as ref_schema
from lighthouse_tpu.types.containers import types_for as ref_types_for
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.crypto.ref_curve import G2
from lighthouse_tpu_torch.harness import Harness
from lighthouse_tpu_torch.state_processing.per_block import BlockSignatureStrategy
from lighthouse_tpu_torch.store import HotColdDB, MemoryStore, SqliteStore, native_kv_store
from lighthouse_tpu_torch.store import schema
from lighthouse_tpu_torch.store.hot_cold import COL_BLOCK, COL_COLD_STATE, COL_HOT_STATE, StoreError
from lighthouse_tpu_torch.types.spec import minimal_spec

N = 16
SLOTS = 12


def _enc(obj):
    return type(obj).encode(obj)


@pytest.fixture(scope="module")
def chain():
    """(genesis, [(signed block, post-state)]) of the port's harness."""
    h = Harness(minimal_spec(ALTAIR_FORK_EPOCH=0), N, backend="fake", device="cpu")
    sig = bls.Signature(G2.generator).to_bytes()  # a valid point, never checked
    h._sign = lambda sk, root, domain: sig
    h._sign_aggregate = lambda validators, root: sig
    genesis = h.state.copy()
    out = []
    for slot in range(1, SLOTS + 1):
        block = h.advance_slot_with_block(slot, strategy=BlockSignatureStrategy.NO_VERIFICATION)
        out.append((block, h.state.copy()))
    return genesis, out


def _ref_obj(obj, slot, kind):
    t = ref_types_for(ref_minimal_spec(ALTAIR_FORK_EPOCH=0))
    cls = (t.signed_block_classes if kind == "block" else t.state_classes)["altair"]
    return cls.decode(_enc(obj))


def _sidecar(t, slot, index):
    sc = t.BlobSidecar(index=index, blob=bytes([index]) * len(t.BlobSidecar().blob))
    sc.signed_block_header.message.slot = slot
    return sc


def _fill(db, genesis, blocks, ref):
    """The writes a chain makes on import, in its order."""
    t = db.t
    conv = (lambda o, s, k: _ref_obj(o, s, k)) if ref else (lambda o, s, k: o)
    db.put_hot_state(conv(genesis, 0, "state"))
    for block, post in blocks:
        slot = int(block.message.slot)
        root = type(block.message).hash_tree_root(block.message)
        db.put_block(root, conv(block, slot, "block"))
        if slot % 5 == 0:
            db.put_blob_sidecar(root, _sidecar(t, slot, 1))
        db.put_hot_state(conv(post, slot, "state"))
        db.set_canonical_block_root(slot, root)


def _columns(kv):
    return {col: dict(rows) for col, rows in kv._data.items()}


def test_same_bytes_per_column_then_migration_and_replay(chain):
    genesis, blocks = chain
    ref = RefHotColdDB(RefMemoryStore(), ref_minimal_spec(ALTAIR_FORK_EPOCH=0), slots_per_restore_point=8)
    port = HotColdDB(MemoryStore(), minimal_spec(ALTAIR_FORK_EPOCH=0), slots_per_restore_point=8,
                     device="cpu")
    _fill(ref, genesis, blocks, ref=True)
    _fill(port, genesis, blocks, ref=False)
    assert _columns(ref.kv) == _columns(port.kv)
    assert len(port.kv.keys(COL_HOT_STATE)) == SLOTS + 1 and len(port.kv.keys(COL_BLOCK)) == SLOTS
    for db in (ref, port):
        db.migrate_to_cold(SLOTS)
    assert _columns(ref.kv) == _columns(port.kv)
    assert port.split_slot == SLOTS and port.get_hot_state(5) is None
    assert sorted(int.from_bytes(k, "big") for k in port.kv.keys(COL_COLD_STATE)) == [0, 8]
    # slot 5 from the restore point at 0, slot 11 from 8: replayed through
    # the port's process_slots and per_block_processing on "cpu"
    for slot in (5, 11):
        rebuilt = port.state_at_slot(slot)
        assert _enc(rebuilt) == _enc(blocks[slot - 1][1]) == _enc(ref.state_at_slot(slot))
    kept = [_enc(sc) for sc in port.get_blob_sidecars_by_range(0, SLOTS + 1)]
    assert kept == [_enc(sc) for sc in ref.get_blob_sidecars_by_range(0, SLOTS + 1)] and len(kept) == 2
    with pytest.raises(StoreError):
        port.put_cold_state(blocks[2][1])


def test_blob_sidecars_round_trip_and_prune():
    spec = minimal_spec(ALTAIR_FORK_EPOCH=0)
    outs = []
    for db in (RefHotColdDB(RefMemoryStore(), ref_minimal_spec(ALTAIR_FORK_EPOCH=0)),
               HotColdDB(MemoryStore(), spec, device="cpu")):
        root = b"\x07" * 32
        for slot, index in ((3, 0), (3, 2), (9, 1)):
            r = root if slot == 3 else b"\x09" * 32
            db.put_blob_sidecar(r, _sidecar(db.t, slot, index))
            db.set_canonical_block_root(slot, r)
        got = [_enc(sc) for sc in db.get_blob_sidecars(root)]
        by_range = [_enc(sc) for sc in db.get_blob_sidecars_by_range(0, 10, limit=2)]
        removed = db.prune_blob_sidecars(5)
        outs.append((got, by_range, removed, _columns(db.kv)))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == 2 and len(outs[1][1]) == 2 and outs[1][2] == 2


def test_sqlite_round_trip_through_a_fresh_handle(chain, tmp_path):
    genesis, blocks = chain
    spec = minimal_spec(ALTAIR_FORK_EPOCH=0)
    path = str(tmp_path / "db.sqlite")
    db = HotColdDB(SqliteStore(path), spec, device="cpu")
    mem = HotColdDB(MemoryStore(), spec, device="cpu")
    for d in (db, mem):
        _fill(d, genesis, blocks[:4], ref=False)
    db.kv.close()
    db2 = HotColdDB(SqliteStore(path), spec, device="cpu")
    for col, rows in _columns(mem.kv).items():
        assert {k: db2.kv.get(col, k) for k in db2.kv.keys(col)} == rows, col
    block, post = blocks[3]
    root = type(block.message).hash_tree_root(block.message)
    assert _enc(db2.get_block(root)) == _enc(block)
    assert _enc(db2.get_hot_state(4)) == _enc(post)
    assert db2.get_canonical_block_root(4) == root
    db2.clear_canonical_block_root(4)
    assert db2.get_canonical_block_root(4) is None
    assert schema.get_schema_version(db2.kv) == schema.CURRENT_SCHEMA_VERSION
    db2.kv.close()


@pytest.mark.parametrize("target", [schema.CURRENT_SCHEMA_VERSION, 2, 1])
def test_schema_steps_equal_to_the_reference(target):
    assert schema.CURRENT_SCHEMA_VERSION == ref_schema.CURRENT_SCHEMA_VERSION
    outs = []
    for sch, store in ((ref_schema, RefMemoryStore()), (schema, MemoryStore())):
        sch.set_schema_version(store, 1)
        store.put(b"idx", (5).to_bytes(8, "little"), b"root5")
        store.put(b"idx", b"s" + (6).to_bytes(8, "little"), b"root6")
        up = sch.migrate_schema(store)
        store.put(b"bsc", b"k", b"v")
        store.put(b"bsi", b"k", b"")
        down = sch.migrate_schema(store, target=target)
        outs.append((up, down, _columns(store)))
    assert outs[0] == outs[1]
    assert outs[1][0] == schema.CURRENT_SCHEMA_VERSION and outs[1][1] == target
    fresh = MemoryStore()
    assert schema.migrate_schema(fresh) == schema.CURRENT_SCHEMA_VERSION
    schema.set_schema_version(fresh, 7)
    with pytest.raises(schema.SchemaError):
        schema.migrate_schema(fresh, target=9)
    with pytest.raises(schema.SchemaError):
        schema.register_migration(1, 3)


def test_native_kv_store_waits_with_its_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        native_kv_store(str(tmp_path / "kv"))
