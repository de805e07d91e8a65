"""Generalized indices and Merkle (multi)proofs over SSZ values.

Role of the reference's consensus/merkle_proof crate plus the spec's
ssz/merkle-proofs.md machinery: a generalized index names one node of a
value's Merkle tree (1 = root, node g has children 2g and 2g+1), so a
field path like ``("finalized_checkpoint", "root")`` in a BeaconState
compiles to a single integer — and a branch proving that node against
the state root is exactly what a sync-committee light client consumes
(LightClientBootstrap/Update, altair light-client sync protocol).

Three layers:

  * path -> gindex (`gindex_for_path`), computed from the SAME type
    descriptors the codec merkleizes with, so the indices can never
    drift from `hash_tree_root` (on this repo's Altair state shape the
    classic spec constants fall out: finalized root 105, current/next
    sync committee 54/55);
  * single-branch extraction/verification (`compute_merkle_proof` /
    `verify_gindex_branch`) via a `TreeOracle` that can resolve ANY
    generalized index of a value lazily — containers, vectors, lists
    (length mix-in included), packed basic sequences;
  * multiproofs (`get_helper_indices` / `compute_multiproof` /
    `verify_multiproof`) per the spec algorithm: one helper-node set
    proving many leaves at once, shared ancestors deduplicated.

The `TreeOracle` accepts precomputed root-layer chunks
(`chunks_override`) so the beacon-state path reuses the incremental
tree-hash cache's per-field roots (`state_field_chunks`) instead of
rehashing million-entry fields; the batched device plane
(`ops/merkle_proof.py`) is byte-identical to the branch folds here and
is cross-checked against them by the committed conformance vectors.
"""

from lighthouse_tpu_torch.ssz import codec as ssz
from lighthouse_tpu_torch.ssz.hashing import hash_concat, zero_hash
from lighthouse_tpu_torch.ssz.merkle import mix_in_length

BYTES_PER_CHUNK = 32


def floorlog2(gindex: int) -> int:
    if gindex < 1:
        raise ValueError(f"invalid generalized index {gindex}")
    return gindex.bit_length() - 1


def concat_gindices(outer: int, inner: int) -> int:
    """Compose generalized indices: `inner` is relative to the subtree
    rooted at `outer` (spec concat_generalized_indices)."""
    return (outer << floorlog2(inner)) | (inner ^ (1 << floorlog2(inner)))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _tree_depth(count: int, limit: int | None) -> int:
    """Depth of the chunk tree merkleize_chunks builds for `count`
    chunks under `limit` (None = pad to next_pow2(count))."""
    eff = _next_pow2(count) if limit is None else _next_pow2(limit)
    return (eff - 1).bit_length() if eff > 1 else 0


# --------------------------------------------------------- chunk layouts


def _pack_chunks(data: bytes) -> list:
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [
        data[i : i + BYTES_PER_CHUNK]
        for i in range(0, len(data), BYTES_PER_CHUNK)
    ]


def _is_container(typ) -> bool:
    return isinstance(typ, type) and issubclass(typ, ssz.Container)


def _layout(typ, value):
    """(chunks, limit, mix_len, child) describing how `typ` merkleizes
    `value`: leaf chunk list, merkleization limit (None = next pow2 of
    count), optional length mix-in, and `child(i) -> (typ_i, value_i)`
    for composite leaves (None for packed/opaque leaves)."""
    if _is_container(typ):
        fields = typ._fields
        chunks = [t.hash_tree_root(getattr(value, f)) for f, t in fields]
        child = lambda i: (fields[i][1], getattr(value, fields[i][0]))  # noqa: E731
        return chunks, None, None, child
    if isinstance(typ, ssz.Vector):
        if isinstance(typ.elem, (ssz.UInt, ssz.Boolean)):
            data = b"".join(typ.elem.encode(v) for v in value)
            return _pack_chunks(data), None, None, None
        chunks = [typ.elem.hash_tree_root(v) for v in value]
        elem = typ.elem
        vals = list(value)
        return chunks, None, None, lambda i: (elem, vals[i])
    if isinstance(typ, ssz.List):
        if isinstance(typ.elem, (ssz.UInt, ssz.Boolean)):
            data = b"".join(typ.elem.encode(v) for v in value)
            limit = max(
                (typ.limit * typ.elem.fixed_size() + BYTES_PER_CHUNK - 1)
                // BYTES_PER_CHUNK,
                1,
            )
            return _pack_chunks(data), limit, len(value), None
        chunks = [typ.elem.hash_tree_root(v) for v in value]
        elem = typ.elem
        vals = list(value)
        return (
            chunks,
            max(typ.limit, 1),
            len(value),
            lambda i: (elem, vals[i]),
        )
    if isinstance(typ, ssz.ByteVector):
        return _pack_chunks(typ.encode(value)), None, None, None
    if isinstance(typ, ssz.ByteList):
        limit = max(
            (typ.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK, 1
        )
        return _pack_chunks(typ.encode(value)), limit, len(value), None
    if isinstance(typ, ssz.Bitvector):
        return (
            _pack_chunks(typ.encode(value)),
            max((typ.length + 255) // 256, 1),
            None,
            None,
        )
    if isinstance(typ, ssz.Bitlist):
        from lighthouse_tpu_torch.ssz.codec import _bits_to_bytes

        data = _bits_to_bytes(list(value)) if value else b""
        return (
            _pack_chunks(data),
            max((typ.limit + 255) // 256, 1),
            len(value),
            None,
        )
    # basic leaf (uint/boolean): a single chunk, no subtree
    return [typ.hash_tree_root(value)], None, None, None


def _chunk_limit(typ) -> int | None:
    """The merkleization limit of `typ`'s data tree from the TYPE alone
    (None = next pow2 of the actual chunk count) — the value-free half
    of `_layout`, used by path->gindex compilation."""
    if _is_container(typ):
        return len(typ._fields)
    if isinstance(typ, ssz.Vector):
        if isinstance(typ.elem, (ssz.UInt, ssz.Boolean)):
            return max(
                (typ.length * typ.elem.fixed_size() + BYTES_PER_CHUNK - 1)
                // BYTES_PER_CHUNK,
                1,
            )
        return typ.length
    if isinstance(typ, ssz.List):
        if isinstance(typ.elem, (ssz.UInt, ssz.Boolean)):
            return max(
                (typ.limit * typ.elem.fixed_size() + BYTES_PER_CHUNK - 1)
                // BYTES_PER_CHUNK,
                1,
            )
        return max(typ.limit, 1)
    if isinstance(typ, ssz.ByteVector):
        return max(
            (typ.length + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK, 1
        )
    if isinstance(typ, ssz.ByteList):
        return max(
            (typ.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK, 1
        )
    if isinstance(typ, ssz.Bitvector):
        return max((typ.length + 255) // 256, 1)
    if isinstance(typ, ssz.Bitlist):
        return max((typ.limit + 255) // 256, 1)
    return 1


def _has_length_mixin(typ) -> bool:
    return isinstance(typ, (ssz.List, ssz.ByteList, ssz.Bitlist))


def gindex_for_path(typ, path) -> int:
    """Compile a field path to a generalized index rooted at `typ`.

    Path steps: a str names a container field; an int indexes a
    composite element (or, for packed basic sequences, a CHUNK). The
    step ``"__len__"`` selects a list's length mix-in chunk."""
    g = 1
    for step in path:
        if step == "__len__":
            if not _has_length_mixin(typ):
                raise ValueError(f"{typ!r} has no length mix-in")
            g = concat_gindices(g, 3)
            typ = ssz.uint64
            continue
        if _has_length_mixin(typ):
            # descend into the data half of the mix-in first
            g = concat_gindices(g, 2)
        if _is_container(typ):
            if not isinstance(step, str):
                raise ValueError(f"container path step {step!r}")
            names = [f for f, _ in typ._fields]
            if step not in names:
                raise ValueError(
                    f"{typ.__name__} has no field {step!r}"
                )
            idx = names.index(step)
            depth = _tree_depth(len(names), None)
            g = concat_gindices(g, (1 << depth) + idx)
            typ = dict(typ._fields)[step]
            continue
        if not isinstance(step, int):
            raise ValueError(f"sequence path step {step!r}")
        limit = _chunk_limit(typ)
        depth = _tree_depth(limit, limit)
        if step >= limit:
            raise ValueError(f"index {step} beyond limit {limit}")
        g = concat_gindices(g, (1 << depth) + step)
        typ = getattr(typ, "elem", ssz.bytes32)
    return g


# ------------------------------------------------------------ tree oracle


class TreeOracle:
    """Lazy resolver for ANY generalized-index node of one SSZ value.

    Layers are built on demand per visited subtree; virtual zero
    padding is served from the zero-hash cache, so resolving a branch
    in a sparse billion-leaf list costs O(depth) hashes, not O(n).
    `chunks_override` replaces the ROOT layout's leaf chunks (the
    beacon-state fast path: per-field roots from the incremental
    tree-hash cache instead of full-field rehashes)."""

    def __init__(self, typ, value, chunks_override=None):
        self.typ = typ
        self.value = value
        self._chunks_override = chunks_override
        self._layers = None  # data-tree layers, built lazily
        self._meta = None  # (limit, mix_len, child)
        self._children: dict = {}

    # --- layout ---

    def _ensure(self):
        if self._meta is None:
            chunks, limit, mix_len, child = _layout(self.typ, self.value)
            if self._chunks_override is not None:
                chunks = list(self._chunks_override)
            depth = _tree_depth(len(chunks), limit)
            layers = [list(chunks)]
            for d in range(depth):
                prev = layers[d]
                nxt = []
                for i in range(0, len(prev), 2):
                    left = prev[i]
                    right = (
                        prev[i + 1] if i + 1 < len(prev) else zero_hash(d)
                    )
                    nxt.append(hash_concat(left, right))
                layers.append(nxt)
            self._layers = layers
            self._meta = (depth, mix_len, child)

    def root(self) -> bytes:
        self._ensure()
        depth, mix_len, _ = self._meta
        top = self._layers[depth]
        data_root = top[0] if top else zero_hash(depth)
        if mix_len is not None:
            return mix_in_length(data_root, mix_len)
        return data_root

    # --- node resolution ---

    def node(self, gindex: int) -> bytes:
        """Hash of the tree node at `gindex` (1 = this value's root)."""
        if gindex == 1:
            return self.root()
        self._ensure()
        depth, mix_len, child = self._meta
        g = gindex
        if mix_len is not None:
            # root children: 2 = data subtree, 3 = length chunk
            top_bit = (g >> (floorlog2(g) - 1)) & 1
            sub = (g & ((1 << (floorlog2(g) - 1)) - 1)) | (
                1 << (floorlog2(g) - 1)
            )
            if top_bit:
                if sub != 1:
                    raise ValueError(
                        f"gindex {gindex} descends below a length chunk"
                    )
                return mix_len.to_bytes(32, "little")
            g = sub
            if g == 1:
                top = self._layers[depth]
                return top[0] if top else zero_hash(depth)
        d = floorlog2(g)
        if d <= depth:
            level = depth - d
            idx = g - (1 << d)
            layer = self._layers[level]
            return layer[idx] if idx < len(layer) else zero_hash(level)
        # the path descends BELOW a leaf chunk: recurse into the child
        leaf_idx = (g >> (d - depth)) - (1 << depth)
        if child is None:
            raise ValueError(
                f"gindex {gindex} descends below a packed leaf"
            )
        rest = (g & ((1 << (d - depth)) - 1)) | (1 << (d - depth))
        oracle = self._children.get(leaf_idx)
        if oracle is None:
            ctyp, cval = child(leaf_idx)
            oracle = TreeOracle(ctyp, cval)
            self._children[leaf_idx] = oracle
        return oracle.node(rest)


# --------------------------------------------------------- single branch


def branch_indices(gindex: int) -> list:
    """Sibling gindices along the path root-ward, bottom-up (spec
    get_branch_indices without the root)."""
    out = []
    g = gindex
    while g > 1:
        out.append(g ^ 1)
        g >>= 1
    return out


def compute_merkle_proof(typ, value, path_or_gindex, chunks_override=None):
    """(leaf, branch, gindex) proving the node at `path_or_gindex`
    against `hash_tree_root(value)`; branch is bottom-up."""
    gindex = (
        path_or_gindex
        if isinstance(path_or_gindex, int)
        else gindex_for_path(typ, path_or_gindex)
    )
    oracle = TreeOracle(typ, value, chunks_override=chunks_override)
    leaf = oracle.node(gindex)
    branch = [oracle.node(s) for s in branch_indices(gindex)]
    return leaf, branch, gindex


def verify_gindex_branch(leaf, branch, gindex: int, root: bytes) -> bool:
    """Fold a bottom-up branch by the gindex's bit path; True iff it
    lands on `root`."""
    if len(branch) != floorlog2(gindex):
        return False
    node = bytes(leaf)
    g = gindex
    for sibling in branch:
        if g & 1:
            node = hash_concat(bytes(sibling), node)
        else:
            node = hash_concat(node, bytes(sibling))
        g >>= 1
    return node == bytes(root)


# ------------------------------------------------------------ multiproof


def _path_indices(gindex: int) -> list:
    out = []
    g = gindex
    while g > 1:
        out.append(g)
        g >>= 1
    return out


def get_helper_indices(gindices) -> list:
    """Minimal helper-node set proving all `gindices` at once (spec
    get_helper_indices): all branch siblings not already on some leaf's
    own path, sorted descending."""
    all_helpers: set = set()
    all_paths: set = set()
    for g in gindices:
        all_helpers.update(branch_indices(g))
        all_paths.update(_path_indices(g))
    return sorted(all_helpers - all_paths, reverse=True)


def compute_multiproof(typ, value, gindices, chunks_override=None):
    """(leaves, helpers) for proving `gindices` together: leaves in the
    given order, helpers in get_helper_indices order."""
    oracle = TreeOracle(typ, value, chunks_override=chunks_override)
    leaves = [oracle.node(g) for g in gindices]
    helpers = [oracle.node(h) for h in get_helper_indices(gindices)]
    return leaves, helpers


def verify_multiproof(leaves, helpers, gindices, root: bytes) -> bool:
    """spec calculate_multi_merkle_root == root."""
    gindices = list(gindices)
    if len(leaves) != len(gindices):
        return False
    helper_indices = get_helper_indices(gindices)
    if len(helpers) != len(helper_indices):
        return False
    objects = {g: bytes(n) for g, n in zip(gindices, leaves)}
    objects.update(
        {g: bytes(n) for g, n in zip(helper_indices, helpers)}
    )
    keys = sorted(objects, reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and k ^ 1 in objects and k // 2 not in objects:
            objects[k // 2] = hash_concat(
                objects[(k | 1) ^ 1], objects[k | 1]
            )
            keys.append(k // 2)
        pos += 1
    return objects.get(1) == bytes(root)


# ------------------------------------------------------- beacon-state path


def state_field_chunks(state) -> list:
    """Per-field root chunks of a beacon state, served from the
    incremental tree-hash cache when one is attached (the import
    pipeline attaches it while computing the post-state root), so proof
    extraction over a just-imported state costs O(log n) — never a
    full-field rehash of the validator registry."""
    cache = state.__dict__.get("_tree_cache")
    if cache is not None and cache.state_cls is type(state):
        return [
            cache.strats[fname].root(getattr(state, fname))
            for fname, _ in state._fields
        ]
    return [
        ftype.hash_tree_root(getattr(state, fname))
        for fname, ftype in state._fields
    ]
