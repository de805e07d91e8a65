"""Versioned on-disk schema with stepwise migrations.

The port of `lighthouse_tpu/store/schema.py`.

Role of beacon_node/store/src/metadata.rs (CURRENT_SCHEMA_VERSION) +
beacon_chain/src/schema_change.rs + the database_manager CLI: the store
records its schema version; on open, registered migrations run stepwise
(v_n -> v_n+1 ... -> current), upgrades and downgrades both supported.
"""

META_COLUMN = b"meta"
SCHEMA_KEY = b"schema_version"

CURRENT_SCHEMA_VERSION = 3


class SchemaError(Exception):
    pass


# (from_version, to_version) -> migration(kv) hooks. Migrations mutate the
# raw KV contents; versions move by exactly one step per hook.
_MIGRATIONS: dict[tuple[int, int], object] = {}


def register_migration(from_v: int, to_v: int):
    if abs(from_v - to_v) != 1:
        raise SchemaError("migrations must move one version at a time")

    def deco(fn):
        _MIGRATIONS[(from_v, to_v)] = fn
        return fn

    return deco


def get_schema_version(kv) -> int | None:
    raw = kv.get(META_COLUMN, SCHEMA_KEY)
    return int.from_bytes(raw, "little") if raw is not None else None


def set_schema_version(kv, version: int) -> None:
    kv.put(META_COLUMN, SCHEMA_KEY, version.to_bytes(8, "little"))


def migrate_schema(kv, target: int = CURRENT_SCHEMA_VERSION) -> int:
    """Bring the store to `target`, running each registered step. A store
    with no version record is stamped directly at `target` — valid
    because every production store is stamped at creation by
    HotColdDB.__init__, so "no record" means "fresh". Raises SchemaError
    if a step has no registered migration."""
    current = get_schema_version(kv)
    if current is None:
        set_schema_version(kv, target)
        return target
    while current != target:
        step = 1 if target > current else -1
        hook = _MIGRATIONS.get((current, current + step))
        if hook is None:
            raise SchemaError(
                f"no migration from v{current} to v{current + step}"
            )
        hook(kv)
        current += step
        set_schema_version(kv, current)
    return current


# ---------------------------------------------------------- v1 <-> v2
# v1 stored canonical block-root index keys as raw u64 slots; v2 prefixes
# them with b"s" (namespacing the index within the column). Serves as the
# template for real migrations and exercises both directions in tests.


@register_migration(1, 2)
def _v1_to_v2(kv):
    col = b"idx"
    for key in list(kv.keys(col)):
        if len(key) == 8:
            val = kv.get(col, key)
            kv.put(col, b"s" + key, val)
            kv.delete(col, key)


@register_migration(2, 1)
def _v2_to_v1(kv):
    col = b"idx"
    for key in list(kv.keys(col)):
        if len(key) == 9 and key[:1] == b"s":
            val = kv.get(col, key)
            kv.put(col, key[1:], val)
            kv.delete(col, key)


# ---------------------------------------------------------- v2 <-> v3
# v3 adds the blob-sidecar columns (b"bsc" data + b"bsi" slot index).
# New columns need no data transform on upgrade; the downgrade drops
# them so a v2 reader never sees keys it cannot interpret.
#
# v3 also changed the BELLATRIX block/body wire shape (the
# blob_kzg_commitments field). No stored-block rewrite is needed: every
# shipped network config (mainnet/minimal/gnosis config.yaml) pins
# BELLATRIX_FORK_EPOCH at FAR_FUTURE, so a durable v2 store cannot
# contain bellatrix-encoded blocks — phase0/altair encodings are
# untouched. Activating bellatrix on a persistent network needs a
# block-rewriting migration alongside it.


@register_migration(2, 3)
def _v2_to_v3(kv):
    pass


@register_migration(3, 2)
def _v3_to_v2(kv):
    for col in (b"bsc", b"bsi"):
        for key in list(kv.keys(col)):
            kv.delete(col, key)
