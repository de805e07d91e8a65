"""The chain's store: the port of `lighthouse_tpu/store/` (KV backends,
the versioned schema, `HotColdDB` and the background migrator). The native
C++ append-log backend waits (ROADMAP Queue 1 item 4)."""

from lighthouse_tpu_torch.store.kv import MemoryStore, SqliteStore  # noqa: F401
from lighthouse_tpu_torch.store.hot_cold import HotColdDB  # noqa: F401
from lighthouse_tpu_torch.store.schema import (  # noqa: F401
    CURRENT_SCHEMA_VERSION,
    SchemaError,
    get_schema_version,
    migrate_schema,
)


def native_kv_store(path):
    """The C++ append-log KV backend (the LevelDB-role store) is not
    ported yet: ROADMAP Queue 1 item 4."""
    raise NotImplementedError(
        "native_kv_store is not ported yet (ROADMAP Queue 1 item 4: "
        "native/kvstore.cc)"
    )
