"""Key-value store backends.

The port of `lighthouse_tpu/store/kv.py`.

Role of the reference's `ItemStore` trait with `LevelDB` and `MemoryStore`
implementations (beacon_node/store/src/leveldb_store.rs:270,
store/src/lib.rs): a byte-keyed store with column families. The persistent
backend here is SQLite (stdlib `sqlite3`, C-implemented, WAL-mode) rather
than LevelDB: same durability contract, zero extra dependencies; the
interface leaves room for an LMDB/LevelDB-style C++ backend later.
"""

import sqlite3
import threading

from lighthouse_tpu_torch.common.locks import TimedLock


class KVStore:
    """Column-family byte KV interface."""

    def get(self, column: bytes, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: bytes, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, column: bytes):
        raise NotImplementedError

    def put_batch(self, items):
        """items: iterable of (column, key, value) — atomic where backend
        supports it."""
        for col, k, v in items:
            self.put(col, k, v)

    def close(self):
        pass


class MemoryStore(KVStore):
    def __init__(self):
        self._data: dict[bytes, dict[bytes, bytes]] = {}
        self._lock = TimedLock("kv.store")

    def get(self, column, key):
        with self._lock:
            return self._data.get(column, {}).get(key)

    def put(self, column, key, value):
        with self._lock:
            self._data.setdefault(column, {})[key] = bytes(value)

    def delete(self, column, key):
        with self._lock:
            self._data.get(column, {}).pop(key, None)

    def keys(self, column):
        with self._lock:
            return list(self._data.get(column, {}).keys())


class SqliteStore(KVStore):
    """Durable KV over sqlite3 with WAL journaling; one table, composite
    (column, key) primary key; batched writes in one transaction."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = TimedLock("kv.store")
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "col BLOB NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
                "PRIMARY KEY (col, key))"
            )
            self._conn.commit()

    def get(self, column, key):
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE col=? AND key=?",
                (column, key),
            ).fetchone()
        return row[0] if row else None

    def put(self, column, key, value):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (col, key, value) VALUES (?,?,?)",
                (column, key, bytes(value)),
            )
            self._conn.commit()

    def put_batch(self, items):
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (col, key, value) VALUES (?,?,?)",
                [(c, k, bytes(v)) for c, k, v in items],
            )
            self._conn.commit()

    def delete(self, column, key):
        with self._lock:
            self._conn.execute(
                "DELETE FROM kv WHERE col=? AND key=?", (column, key)
            )
            self._conn.commit()

    def keys(self, column):
        with self._lock:
            rows = self._conn.execute(
                "SELECT key FROM kv WHERE col=?", (column,)
            ).fetchall()
        return [r[0] for r in rows]

    def close(self):
        with self._lock:
            self._conn.close()
