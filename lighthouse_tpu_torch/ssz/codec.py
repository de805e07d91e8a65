"""SSZ type descriptors: encode/decode + hash_tree_root.

Python re-design of the reference's SSZ trait stack (consensus/ssz/src for
Encode/Decode, consensus/ssz_types/src for FixedVector/VariableList/
Bitfield, consensus/ssz_derive for container derive, consensus/tree_hash for
TreeHash). Types are *descriptor objects*; containers are declarative
classes. Values are plain Python (int, bool, bytes, list, container
instances), keeping the state-transition layer free of codec details.
"""

from __future__ import annotations

from lighthouse_tpu_torch.ssz.hashing import hash32
from lighthouse_tpu_torch.ssz.merkle import (
    merkleize_chunks,
    mix_in_length,
    mix_in_selector,
)

BYTES_PER_CHUNK = 32
OFFSET_SIZE = 4


def _pack_bytes_to_chunks(data: bytes):
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [
        data[i : i + BYTES_PER_CHUNK]
        for i in range(0, len(data), BYTES_PER_CHUNK)
    ]


class SSZType:
    """Base descriptor. Subclasses implement the wire codec + tree hash."""

    def is_fixed(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def encode(self, value) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


# ------------------------------------------------------------------- basics


class UInt(SSZType):
    def __init__(self, bits: int):
        assert bits in (8, 16, 32, 64, 128, 256)
        self.bits = bits
        self.nbytes = bits // 8

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.nbytes

    def encode(self, value) -> bytes:
        return int(value).to_bytes(self.nbytes, "little")

    def decode(self, data: bytes):
        if len(data) != self.nbytes:
            raise ValueError(f"uint{self.bits}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def default(self):
        return 0

    def __repr__(self):
        return f"uint{self.bits}"


class Boolean(SSZType):
    def is_fixed(self):
        return True

    def fixed_size(self):
        return 1

    def encode(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def decode(self, data: bytes):
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("boolean: invalid encoding")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def default(self):
        return False


uint8 = UInt(8)
uint16 = UInt(16)
uint32 = UInt(32)
uint64 = UInt(64)
uint128 = UInt(128)
uint256 = UInt(256)
byte = uint8
boolean = Boolean()


# -------------------------------------------------------------- byte arrays


class ByteVector(SSZType):
    """bytes of a fixed length (alias of Vector[byte, N] with bytes values)."""

    def __init__(self, length: int):
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.length

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(
                f"ByteVector[{self.length}]: got {len(value)} bytes"
            )
        return value

    def decode(self, data: bytes):
        if len(data) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: bad length")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize_chunks(_pack_bytes_to_chunks(self.encode(value)))

    def default(self):
        return b"\x00" * self.length

    def __repr__(self):
        return f"ByteVector[{self.length}]"


class ByteList(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: too long")
        return value

    def decode(self, data: bytes):
        if len(data) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: too long")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = self.encode(value)
        limit_chunks = (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        root = merkleize_chunks(
            _pack_bytes_to_chunks(value), limit=max(limit_chunks, 1)
        )
        return mix_in_length(root, len(value))

    def default(self):
        return b""

    def __repr__(self):
        return f"ByteList[{self.limit}]"


bytes4 = ByteVector(4)
bytes20 = ByteVector(20)
bytes32 = ByteVector(32)
bytes48 = ByteVector(48)
bytes96 = ByteVector(96)


# ------------------------------------------------------------- homogeneous


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        assert length > 0
        self.elem = elem
        self.length = length

    def is_fixed(self):
        return self.elem.is_fixed()

    def fixed_size(self):
        return self.elem.fixed_size() * self.length

    def encode(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError(
                f"Vector[{self.elem},{self.length}]: got {len(value)}"
            )
        return _encode_sequence(self.elem, value)

    def decode(self, data: bytes):
        out = _decode_sequence(self.elem, data)
        if len(out) != self.length:
            raise ValueError("Vector: wrong element count")
        return out

    def hash_tree_root(self, value) -> bytes:
        if isinstance(self.elem, (UInt, Boolean)):
            data = b"".join(self.elem.encode(v) for v in value)
            return merkleize_chunks(_pack_bytes_to_chunks(data))
        return merkleize_chunks(
            [self.elem.hash_tree_root(v) for v in value]
        )

    def default(self):
        return [self.elem.default() for _ in range(self.length)]

    def __repr__(self):
        return f"Vector[{self.elem},{self.length}]"


class List(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"List[{self.elem},{self.limit}]: too long")
        return _encode_sequence(self.elem, value)

    def decode(self, data: bytes):
        out = _decode_sequence(self.elem, data)
        if len(out) > self.limit:
            raise ValueError("List: too long")
        return out

    def hash_tree_root(self, value) -> bytes:
        if isinstance(self.elem, (UInt, Boolean)):
            data = b"".join(self.elem.encode(v) for v in value)
            limit_chunks = (
                self.limit * self.elem.fixed_size() + BYTES_PER_CHUNK - 1
            ) // BYTES_PER_CHUNK
            root = merkleize_chunks(
                _pack_bytes_to_chunks(data), limit=max(limit_chunks, 1)
            )
        else:
            root = merkleize_chunks(
                [self.elem.hash_tree_root(v) for v in value],
                limit=max(self.limit, 1),
            )
        return mix_in_length(root, len(value))

    def default(self):
        return []

    def __repr__(self):
        return f"List[{self.elem},{self.limit}]"


def _encode_sequence(elem: SSZType, values) -> bytes:
    if elem.is_fixed():
        return b"".join(elem.encode(v) for v in values)
    parts = [elem.encode(v) for v in values]
    offset = OFFSET_SIZE * len(parts)
    out = []
    for p in parts:
        out.append(offset.to_bytes(OFFSET_SIZE, "little"))
        offset += len(p)
    return b"".join(out) + b"".join(parts)


def _decode_sequence(elem: SSZType, data: bytes):
    if elem.is_fixed():
        size = elem.fixed_size()
        if size == 0 or len(data) % size:
            raise ValueError("sequence: length not a multiple of elem size")
        return [
            elem.decode(data[i : i + size]) for i in range(0, len(data), size)
        ]
    if not data:
        return []
    first_off = int.from_bytes(data[:OFFSET_SIZE], "little")
    if first_off % OFFSET_SIZE or first_off > len(data):
        raise ValueError("sequence: bad first offset")
    n = first_off // OFFSET_SIZE
    offsets = [
        int.from_bytes(data[i * OFFSET_SIZE : (i + 1) * OFFSET_SIZE], "little")
        for i in range(n)
    ]
    offsets.append(len(data))
    out = []
    for i in range(n):
        if offsets[i] > offsets[i + 1]:
            raise ValueError("sequence: non-monotonic offsets")
        out.append(elem.decode(data[offsets[i] : offsets[i + 1]]))
    return out


# ---------------------------------------------------------------- bitfields


class Bitvector(SSZType):
    """Fixed-length bit array; value is a list[bool] of exactly `length`."""

    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def encode(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Bitvector[{self.length}]: got {len(value)}")
        return _bits_to_bytes(value)

    def decode(self, data: bytes):
        if len(data) != self.fixed_size():
            raise ValueError("Bitvector: bad length")
        bits = _bytes_to_bits(data, self.length)
        # excess bits in the final byte must be zero
        if any(_bytes_to_bits(data, len(data) * 8)[self.length :]):
            raise ValueError("Bitvector: high bits set")
        return bits

    def hash_tree_root(self, value) -> bytes:
        return merkleize_chunks(
            _pack_bytes_to_chunks(self.encode(value)),
            limit=max((self.length + 255) // 256, 1),
        )

    def default(self):
        return [False] * self.length

    def __repr__(self):
        return f"Bitvector[{self.length}]"


class Bitlist(SSZType):
    """Variable-length bit array with capacity `limit`; value is list[bool].

    Wire format appends a single delimiting 1-bit past the last data bit.
    """

    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: too long")
        return _bits_to_bytes(list(value) + [True])

    def decode(self, data: bytes):
        if not data:
            raise ValueError("Bitlist: empty")
        nbits = len(data) * 8
        bits = _bytes_to_bits(data, nbits)
        # find delimiter: highest set bit
        hi = nbits - 1
        while hi >= 0 and not bits[hi]:
            hi -= 1
        if hi < 0:
            raise ValueError("Bitlist: missing delimiter")
        if nbits - hi > 8:
            raise ValueError("Bitlist: delimiter not in final byte")
        out = bits[:hi]
        if len(out) > self.limit:
            raise ValueError("Bitlist: too long")
        return out

    def hash_tree_root(self, value) -> bytes:
        data = _bits_to_bytes(list(value)) if value else b""
        root = merkleize_chunks(
            _pack_bytes_to_chunks(data),
            limit=max((self.limit + 255) // 256, 1),
        )
        return mix_in_length(root, len(value))

    def default(self):
        return []

    def __repr__(self):
        return f"Bitlist[{self.limit}]"


def _bits_to_bytes(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _bytes_to_bits(data: bytes, nbits: int):
    return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(nbits)]


# ---------------------------------------------------------------- container


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields = []
        for base in reversed(cls.__mro__):
            fields.extend(getattr(base, "__annotations__", {}).items())
        # keep only SSZType-annotated entries, in declaration order
        def is_ssz(t):
            return isinstance(t, SSZType) or (
                isinstance(t, type) and issubclass(t, Container)
            )

        cls._fields = [
            (fname, ftype) for fname, ftype in fields if is_ssz(ftype)
        ]
        return cls


class Container(SSZType, metaclass=_ContainerMeta):
    """Declarative SSZ container.

    class Checkpoint(Container):
        epoch: uint64
        root:  bytes32

    The class itself is the type descriptor (classmethod codec), instances
    are the values.
    """

    def __init__(self, **kwargs):
        for fname, ftype in self._fields:
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, ftype.default())
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def __setattr__(self, name, value):
        """Every direct field write bumps a mutation counter — the hook
        the incremental tree-hash cache (ssz/cached_hash.py) uses to
        detect changed elements without shadow-comparing values."""
        d = self.__dict__
        d[name] = value
        d["_muts"] = d.get("_muts", 0) + 1

    # --- descriptor protocol (class-level) ---

    @classmethod
    def is_fixed(cls):
        return all(t.is_fixed() for _, t in cls._fields)

    @classmethod
    def fixed_size(cls):
        return sum(t.fixed_size() for _, t in cls._fields)

    @classmethod
    def encode(cls, value=None) -> bytes:
        v = value
        fixed_parts, var_parts = [], []
        for fname, ftype in cls._fields:
            fv = getattr(v, fname)
            if ftype.is_fixed():
                fixed_parts.append(ftype.encode(fv))
                var_parts.append(None)
            else:
                fixed_parts.append(None)
                var_parts.append(ftype.encode(fv))
        fixed_len = sum(
            len(p) if p is not None else OFFSET_SIZE for p in fixed_parts
        )
        out, var_out = [], []
        offset = fixed_len
        for fp, vp in zip(fixed_parts, var_parts):
            if fp is not None:
                out.append(fp)
            else:
                out.append(offset.to_bytes(OFFSET_SIZE, "little"))
                var_out.append(vp)
                offset += len(vp)
        return b"".join(out) + b"".join(var_out)

    def to_bytes(self) -> bytes:
        return type(self).encode(self)

    @classmethod
    def decode(cls, data: bytes):
        pos = 0
        values = {}
        offsets = []  # (fname, ftype, offset)
        fixed_len = sum(
            t.fixed_size() if t.is_fixed() else OFFSET_SIZE
            for _, t in cls._fields
        )
        for fname, ftype in cls._fields:
            if ftype.is_fixed():
                size = ftype.fixed_size()
                values[fname] = ftype.decode(data[pos : pos + size])
                pos += size
            else:
                off = int.from_bytes(data[pos : pos + OFFSET_SIZE], "little")
                offsets.append((fname, ftype, off))
                pos += OFFSET_SIZE
        if offsets:
            if offsets[0][2] != fixed_len:
                raise ValueError("container: bad first offset")
            bounds = [o for _, _, o in offsets] + [len(data)]
            for i, (fname, ftype, off) in enumerate(offsets):
                if bounds[i] > bounds[i + 1]:
                    raise ValueError("container: non-monotonic offsets")
                values[fname] = ftype.decode(data[off : bounds[i + 1]])
        elif pos != len(data):
            raise ValueError("container: trailing bytes")
        return cls(**values)

    @classmethod
    def hash_tree_root(cls, value=None) -> bytes:
        v = value
        return merkleize_chunks(
            [t.hash_tree_root(getattr(v, f)) for f, t in cls._fields]
        )

    @property
    def tree_root(self) -> bytes:
        return type(self).hash_tree_root(self)

    @classmethod
    def default(cls):
        return cls()

    # --- value conveniences ---

    def copy(self):
        """Deep copy (containers/lists copied; bytes/ints shared)."""
        out = type(self).__new__(type(self))
        for fname, ftype in self._fields:
            out_v = _copy_value(getattr(self, fname))
            setattr(out, fname, out_v)
        return out

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, f) == getattr(other, f) for f, _ in self._fields
        )

    def __repr__(self):
        inner = ", ".join(
            f"{f}={getattr(self, f)!r}" for f, _ in self._fields[:4]
        )
        more = "..." if len(self._fields) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"


def _copy_value(v):
    if isinstance(v, Container):
        return v.copy()
    if isinstance(v, list):
        return [_copy_value(x) for x in v]
    return v


# -------------------------------------------------------------------- union


class Union(SSZType):
    """SSZ Union: 1-byte selector + encoded option. Option 0 may be None."""

    def __init__(self, options):
        self.options = options  # list of SSZType or None (only index 0)

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        selector, inner = value
        opt = self.options[selector]
        if opt is None:
            return bytes([selector])
        return bytes([selector]) + opt.encode(inner)

    def decode(self, data: bytes):
        selector = data[0]
        opt = self.options[selector]
        if opt is None:
            if len(data) != 1:
                raise ValueError("union: trailing bytes after None")
            return (0, None)
        return (selector, opt.decode(data[1:]))

    def hash_tree_root(self, value) -> bytes:
        selector, inner = value
        opt = self.options[selector]
        root = (
            b"\x00" * 32 if opt is None else opt.hash_tree_root(inner)
        )
        return mix_in_selector(root, selector)

    def default(self):
        opt = self.options[0]
        return (0, None if opt is None else opt.default())
