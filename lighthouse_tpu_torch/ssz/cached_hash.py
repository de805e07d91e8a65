"""Incremental (cached) tree hashing for the beacon state.

Role of /root/reference/consensus/cached_tree_hash/src/cache.rs +
cache_arena.rs: the reference amortizes state-root computation with
per-field chunk caches invalidated by writes, so the per-slot root is
O(changes · log n) instead of a full-state rehash. At mainnet state sizes
(~500k validators) a full rehash per slot would dwarf the signature plane.

Design (tpu-repo flavor): rather than an intrusive arena, each cacheable
field gets a *strategy* that (a) detects changed leaves cheaply and
(b) patches only the affected Merkle paths of a retained chunk tree:

  * `validators` / `eth1_data_votes` — per-element memo keyed by (object
    identity, mutation counter); a value-identical replacement (e.g.
    after `state.copy()`) heals by comparing the recomputed element root.
    Sound because the element types are FLAT (every field is a
    uint/bool/bytes scalar), so any mutation goes through
    `Container.__setattr__` and bumps the element's mutation counter.
  * `balances` / participation / `inactivity_scores` / `slashings` —
    packed uint leaves shadowed by a numpy array; dirty chunks found with
    one vectorized compare.
  * `block_roots` / `state_roots` / `randao_mixes` / `historical_roots`
    — bytes32 leaves shadowed by reference identity then equality.
  * sync committees / execution-payload header / `latest_block_header` —
    whole-value memo (replaced wholesale by the state transition).
  * anything else — recompute (tiny fields; correctness by default).

Correctness backstop: the port's tests hold every cached root against the
full recompute (`type(state).hash_tree_root(state)`) and against the JAX
package's roots.

Cache lifetime: `cached_state_root(state)` attaches the cache to the
state instance. `carry_tree_cache(new_state, old_state)` transplants a
cache across `state.copy()` (the block-import pipeline copies the parent
state before mutating it); the transplant deep-copies the mutable tree
layers so parent and child caches never alias.
"""

import numpy as np

from lighthouse_tpu_torch.ssz.hashing import hash32_many, hash_concat, zero_hash
from lighthouse_tpu_torch.ssz.merkle import merkleize_chunks, mix_in_length


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class CachedChunkTree:
    """A retained Merkle tree over 32-byte chunks with virtual zero
    padding to `limit_chunks`, updatable by leaf index in O(log n) hashes
    per dirty leaf (batched per level)."""

    __slots__ = ("depth", "layers", "count")

    def __init__(self, chunks, limit_chunks: int):
        limit = _next_pow2(limit_chunks)
        self.depth = (limit - 1).bit_length() if limit > 1 else 0
        self.count = len(chunks)
        if self.count > limit_chunks:
            raise ValueError("chunk count exceeds limit")
        layer = list(chunks)
        self.layers = [layer]
        for d in range(self.depth):
            if len(layer) % 2 and len(layer) > 0:
                layer = layer + [zero_hash(d)]
            nxt = (
                hash32_many(
                    [layer[i] + layer[i + 1] for i in range(0, len(layer), 2)]
                )
                if layer
                else []
            )
            self.layers.append(nxt)
            layer = nxt

    def root(self) -> bytes:
        if self.count == 0:
            return zero_hash(self.depth)
        return self.layers[self.depth][0]

    def set_leaves(self, updates: dict) -> None:
        """Apply {leaf_index: chunk} (indices may extend the tree by
        appending past count-1) and re-hash only the affected paths."""
        layer0 = self.layers[0]
        for idx in sorted(updates):
            if idx < len(layer0):
                layer0[idx] = updates[idx]
            elif idx == len(layer0):
                layer0.append(updates[idx])
            else:
                raise ValueError("non-contiguous append")
        self.count = max(self.count, max(updates) + 1) if updates else self.count
        dirty = set(updates)
        for d in range(self.depth):
            cur = self.layers[d]
            parent_layer = self.layers[d + 1]
            parents = sorted({i >> 1 for i in dirty})
            for p in parents:
                left = cur[2 * p]
                right = (
                    cur[2 * p + 1] if 2 * p + 1 < len(cur) else zero_hash(d)
                )
                h = hash_concat(left, right)
                if p < len(parent_layer):
                    parent_layer[p] = h
                else:
                    parent_layer.append(h)
            dirty = set(parents)

    def clone(self) -> "CachedChunkTree":
        out = CachedChunkTree.__new__(CachedChunkTree)
        out.depth = self.depth
        out.count = self.count
        out.layers = [list(layer) for layer in self.layers]
        return out


# --------------------------------------------------------------- strategies


class _Recompute:
    def __init__(self, ftype):
        self.ftype = ftype

    def root(self, value) -> bytes:
        return self.ftype.hash_tree_root(value)

    def clone(self):
        return self


class _Memo:
    """Whole-value memo for fields replaced wholesale (sync committees,
    payload header, latest_block_header). Keyed by identity + mutation
    counter; any in-place write to a direct field bumps the counter."""

    def __init__(self, ftype):
        self.ftype = ftype
        self.obj = None
        self.muts = -1
        self.cached = None

    def root(self, value) -> bytes:
        muts = value.__dict__.get("_muts", 0) if hasattr(value, "__dict__") else 0
        if self.cached is None or self.obj is not value or self.muts != muts:
            self.cached = self.ftype.hash_tree_root(value)
            self.obj, self.muts = value, muts
        return self.cached

    def clone(self):
        out = _Memo(self.ftype)
        out.obj, out.muts, out.cached = self.obj, self.muts, self.cached
        return out


class _FlatContainerList:
    """List of FLAT containers (all fields scalar): per-element memo by
    (identity, mutation counter) + retained chunk tree + length mix-in.

    A value-identical replacement object (post-copy without carry) heals:
    the element root is recomputed, matches the cached one, and the memo
    re-keys without touching the tree."""

    def __init__(self, elem_type, limit: int):
        self.elem = elem_type
        self.limit = limit
        self.entries = []  # [obj, muts, root]
        self.tree = None

    def root(self, value) -> bytes:
        n = len(value)
        if self.tree is None or n < len(self.entries):
            # first use, or the list shrank (epoch rotation): full build
            roots = [self.elem.hash_tree_root(v) for v in value]
            self.entries = [
                [v, v.__dict__.get("_muts", 0), r]
                for v, r in zip(value, roots)
            ]
            self.tree = CachedChunkTree(roots, self.limit)
            return mix_in_length(self.tree.root(), n)
        dirty = {}
        entries = self.entries
        for i, v in enumerate(value):
            muts = v.__dict__.get("_muts", 0)
            if i < len(entries):
                e = entries[i]
                if e[0] is v and e[1] == muts:
                    continue
                r = self.elem.hash_tree_root(v)
                if e[2] == r:  # value-identical copy: heal, no tree work
                    e[0], e[1] = v, muts
                    continue
                e[0], e[1], e[2] = v, muts, r
                dirty[i] = r
            else:
                r = self.elem.hash_tree_root(v)
                entries.append([v, muts, r])
                dirty[i] = r
        if dirty:
            self.tree.set_leaves(dirty)
        return mix_in_length(self.tree.root(), n)

    def clone(self):
        out = _FlatContainerList(self.elem, self.limit)
        out.entries = [list(e) for e in self.entries]
        out.tree = self.tree.clone() if self.tree is not None else None
        return out

    def carry_to(self, new_value):
        """Re-key the memo onto the value-identical copied elements so a
        post-copy root() does zero element rehashes."""
        if len(new_value) != len(self.entries):
            return
        for e, v in zip(self.entries, new_value):
            e[0] = v
            e[1] = v.__dict__.get("_muts", 0)


class _PackedInts:
    """uintN list/vector leaves shadowed by a numpy array; dirty chunks
    via one vectorized compare."""

    def __init__(self, dtype: str, limit_elems: int, is_list: bool):
        self.dtype = np.dtype(dtype)
        self.per_chunk = 32 // self.dtype.itemsize
        self.limit_chunks = max(
            (limit_elems + self.per_chunk - 1) // self.per_chunk, 1
        )
        self.is_list = is_list
        self.shadow = None
        self.tree = None

    def _chunks(self, data: bytes):
        if len(data) % 32:
            data = data + b"\x00" * (32 - len(data) % 32)
        return [data[i : i + 32] for i in range(0, len(data), 32)]

    def root(self, value) -> bytes:
        arr = np.asarray(value, dtype=self.dtype)
        n = len(arr)
        if (
            self.tree is None
            or self.shadow is None
            or n < len(self.shadow)
        ):
            chunks = self._chunks(arr.tobytes())
            self.tree = CachedChunkTree(chunks, self.limit_chunks)
            self.shadow = arr.copy()
        else:
            shadow = self.shadow
            dirty_chunks = set()
            if n > len(shadow):
                grown = range(
                    len(shadow) // self.per_chunk,
                    (n + self.per_chunk - 1) // self.per_chunk,
                )
                dirty_chunks.update(grown)
            m = len(shadow)
            if m:
                diff = np.nonzero(arr[:m] != shadow[:m])[0]
                dirty_chunks.update((diff // self.per_chunk).tolist())
            if dirty_chunks:
                data = arr.tobytes()
                padded = data + b"\x00" * (
                    (-len(data)) % 32
                )
                updates = {
                    c: padded[c * 32 : c * 32 + 32]
                    for c in sorted(dirty_chunks)
                }
                self.tree.set_leaves(updates)
                self.shadow = arr.copy()
            elif n != len(shadow):
                self.shadow = arr.copy()
        root = self.tree.root()
        return mix_in_length(root, n) if self.is_list else root

    def clone(self):
        out = _PackedInts.__new__(_PackedInts)
        out.dtype = self.dtype
        out.per_chunk = self.per_chunk
        out.limit_chunks = self.limit_chunks
        out.is_list = self.is_list
        out.shadow = None if self.shadow is None else self.shadow.copy()
        out.tree = self.tree.clone() if self.tree is not None else None
        return out


class _Bytes32Seq:
    """Vector/list of 32-byte roots; shadow compare by identity then
    equality (unchanged entries are usually the same bytes object)."""

    def __init__(self, limit_elems: int, is_list: bool):
        self.limit = max(limit_elems, 1)
        self.is_list = is_list
        self.shadow = None
        self.tree = None

    def root(self, value) -> bytes:
        n = len(value)
        if self.tree is None or self.shadow is None or n < len(self.shadow):
            chunks = [bytes(v) for v in value]
            self.tree = CachedChunkTree(chunks, self.limit)
            self.shadow = list(chunks)
        else:
            shadow = self.shadow
            updates = {}
            for i, v in enumerate(value):
                if i < len(shadow):
                    if v is shadow[i]:
                        continue
                    b = bytes(v)
                    if b == shadow[i]:
                        shadow[i] = v if isinstance(v, bytes) else b
                        continue
                    updates[i] = b
                    shadow[i] = b
                else:
                    b = bytes(v)
                    updates[i] = b
                    shadow.append(b)
            if updates:
                self.tree.set_leaves(updates)
        root = self.tree.root()
        return mix_in_length(root, n) if self.is_list else root

    def clone(self):
        out = _Bytes32Seq(self.limit, self.is_list)
        out.shadow = None if self.shadow is None else list(self.shadow)
        out.tree = self.tree.clone() if self.tree is not None else None
        return out


# ----------------------------------------------------------- state cache


def _is_flat_container(cls) -> bool:
    from lighthouse_tpu_torch.ssz import codec as ssz

    if not (isinstance(cls, type) and issubclass(cls, ssz.Container)):
        return False
    return all(
        isinstance(t, (ssz.UInt, ssz.Boolean, ssz.ByteVector))
        for _, t in cls._fields
    )


def _strategy_for(fname: str, ftype):
    """Pick the incremental strategy for a state field; recompute is the
    correct-by-default fallback for anything not special-cased."""
    from lighthouse_tpu_torch.ssz import codec as ssz

    if isinstance(ftype, ssz.List):
        elem = ftype.elem
        if isinstance(elem, ssz.UInt):
            return _PackedInts(
                f"<u{elem.fixed_size()}", ftype.limit, is_list=True
            )
        if isinstance(elem, ssz.ByteVector) and elem.fixed_size() == 32:
            return _Bytes32Seq(ftype.limit, is_list=True)
        if _is_flat_container(elem):
            return _FlatContainerList(elem, ftype.limit)
        return _Recompute(ftype)
    if isinstance(ftype, ssz.Vector):
        elem = ftype.elem
        if isinstance(elem, ssz.UInt):
            return _PackedInts(
                f"<u{elem.fixed_size()}",
                ftype.length,
                is_list=False,
            )
        if isinstance(elem, ssz.ByteVector) and elem.fixed_size() == 32:
            return _Bytes32Seq(ftype.length, is_list=False)
        return _Recompute(ftype)
    if fname in (
        "current_sync_committee",
        "next_sync_committee",
        "latest_execution_payload_header",
        "latest_block_header",
    ):
        return _Memo(ftype)
    return _Recompute(ftype)


class StateTreeCache:
    def __init__(self, state_cls):
        self.state_cls = state_cls
        self.strats = {
            fname: _strategy_for(fname, ftype)
            for fname, ftype in state_cls._fields
        }

    def root(self, state) -> bytes:
        field_roots = [
            self.strats[fname].root(getattr(state, fname))
            for fname, _ in state._fields
        ]
        return merkleize_chunks(field_roots)

    def clone(self) -> "StateTreeCache":
        out = StateTreeCache.__new__(StateTreeCache)
        out.state_cls = self.state_cls
        out.strats = {k: s.clone() for k, s in self.strats.items()}
        return out


def cached_state_root(state) -> bytes:
    """Incremental hash_tree_root for a beacon state. The cache rides on
    the instance; use `carry_tree_cache` after `state.copy()` to avoid a
    rebuild on the copy."""
    cache = state.__dict__.get("_tree_cache")
    if cache is None or cache.state_cls is not type(state):
        cache = StateTreeCache(type(state))
        state.__dict__["_tree_cache"] = cache
    return cache.root(state)


def carry_tree_cache(new_state, old_state) -> None:
    """Transplant the tree cache across `old_state.copy()` -> new_state.

    Must be called BEFORE new_state is mutated (the transplant re-keys
    per-element memos onto the value-identical copied elements). Tree
    layers are deep-copied so the two caches never alias."""
    old = old_state.__dict__.get("_tree_cache")
    if old is None or old.state_cls is not type(new_state):
        return
    cache = old.clone()
    for fname, strat in cache.strats.items():
        if isinstance(strat, _FlatContainerList):
            strat.carry_to(getattr(new_state, fname))
    new_state.__dict__["_tree_cache"] = cache
