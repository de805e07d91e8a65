"""Snappy codec: raw block format + framing, native-accelerated.

The port of `lighthouse_tpu/network/snappy_codec.py`.

Role of the reference's `snap` crate usage: gossip messages are
raw-snappy-block compressed (lighthouse_network/src/types/pubsub.rs) and
req/resp streams use the snappy FRAME format with masked CRC32C
(rpc/codec/ssz_snappy.rs). Compression uses the C matcher
(native/snappy.c, built with cc into the package's `build/` at first
use) when the toolchain is available; decompression and the frame layer
always verify lengths/checksums. The pure-Python fallback
compressor emits literal-only blocks — valid snappy, just uncompressed.
"""

import ctypes
import os
import struct
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "snappy.c")
_BUILD = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD, "_snappy.so")

_lib = None
_lib_lock = threading.Lock()


class SnappyError(ValueError):
    pass


def build(force: bool = False) -> bool:
    """Compile `native/snappy.c` with cc into the package's `build/`;
    returns True when a current library is there."""
    try:
        fresh = os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    except OSError:
        fresh = os.path.exists(_SO)
    if fresh and not force:
        return True
    os.makedirs(_BUILD, exist_ok=True)
    # build under a per-process name, then rename: concurrent processes
    # must never CDLL a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["cc", "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    global _lib
    if _lib is not None:  # lock-free fast path; _lib written once under lock
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not build():
            _lib = False
            return False
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _lib = False
            return False
        lib.snappy_max_compressed.restype = ctypes.c_uint32
        lib.snappy_max_compressed.argtypes = [ctypes.c_uint32]
        lib.snappy_compress.restype = ctypes.c_uint32
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p
        ]
        lib.snappy_uncompress.restype = ctypes.c_int64  # -1 = malformed
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.snappy_crc32c.restype = ctypes.c_uint32
        lib.snappy_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        _lib = lib
        return lib


def native_available() -> bool:
    return bool(_load())


# ------------------------------------------------------------ raw block


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def compress_block(data: bytes) -> bytes:
    """Raw snappy block. Native matcher when available; else a valid
    literal-only encoding."""
    lib = _load()
    if lib:
        cap = lib.snappy_max_compressed(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.snappy_compress(data, len(data), out)
        if n:
            return out.raw[:n]
    # literal-only fallback
    out = bytearray(_varint(len(data)))
    i = 0
    while i < len(data):
        chunk = data[i : i + 65536]
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        else:
            out.append(61 << 2)
            out += struct.pack("<H", n)
        out += chunk
        i += len(chunk)
    return bytes(out)


def _read_varint(data: bytes, pos: int):
    result = shift = 0
    while True:
        if pos >= len(data) or shift > 28:
            raise SnappyError("bad varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decompress_block(data: bytes, max_len: int = 1 << 27) -> bytes:
    """Raw snappy block decode with full validation."""
    expect, pos = _read_varint(data, 0)
    if expect > max_len:
        raise SnappyError("declared length too large")
    lib = _load()
    if lib:
        out = ctypes.create_string_buffer(max(expect, 1))
        n = lib.snappy_uncompress(data, len(data), out, expect)
        if n != expect:
            raise SnappyError("malformed snappy block")
        return out.raw[:expect]
    # pure-Python decode
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                if n - pos < extra:
                    raise SnappyError("truncated length")
                ln = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if ln > n - pos:
                raise SnappyError("truncated literal")
            out += data[pos : pos + ln]
            pos += ln
        else:
            if kind == 1:
                if pos >= n:
                    raise SnappyError("truncated copy")
                ln = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                if n - pos < 2:
                    raise SnappyError("truncated copy")
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                if n - pos < 4:
                    raise SnappyError("truncated copy")
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise SnappyError("bad copy offset")
            for _i in range(ln):
                out.append(out[-offset])
        if len(out) > expect:
            raise SnappyError("overrun")
    if len(out) != expect:
        raise SnappyError("length mismatch")
    return bytes(out)


# --------------------------------------------------------------- framing

_STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01


def _crc32c(data: bytes) -> int:
    lib = _load()
    if lib:
        return lib.snappy_crc32c(data, len(data))
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (0x82F63B78 ^ (crc >> 1)) if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_compress(data: bytes) -> bytes:
    """Snappy frame format (the req/resp ssz_snappy stream encoding)."""
    out = bytearray(_STREAM_IDENTIFIER)
    for i in range(0, max(len(data), 1), 65536):
        chunk = data[i : i + 65536]
        body = compress_block(chunk)
        if len(body) < len(chunk):
            ctype = _CHUNK_COMPRESSED
        else:
            ctype, body = _CHUNK_UNCOMPRESSED, chunk
        payload = struct.pack("<I", _masked_crc(chunk)) + body
        out.append(ctype)
        out += struct.pack("<I", len(payload))[:3]
        out += payload
    return bytes(out)


def frame_decompress(data: bytes, max_len: int = 1 << 27) -> bytes:
    if not data.startswith(_STREAM_IDENTIFIER):
        raise SnappyError("missing stream identifier")
    pos = len(_STREAM_IDENTIFIER)
    out = bytearray()
    while pos < len(data):
        if pos + 4 > len(data):
            raise SnappyError("truncated chunk header")
        ctype = data[pos]
        ln = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + ln > len(data):
            raise SnappyError("truncated chunk")
        chunk = data[pos : pos + ln]
        pos += ln
        if ctype in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
            if ln < 4:
                raise SnappyError("chunk too short")
            want_crc = int.from_bytes(chunk[:4], "little")
            body = chunk[4:]
            plain = (
                decompress_block(body, max_len)
                if ctype == _CHUNK_COMPRESSED
                else body
            )
            if _masked_crc(plain) != want_crc:
                raise SnappyError("checksum mismatch")
            out += plain
            if len(out) > max_len:
                raise SnappyError("stream too large")
        elif ctype == 0xFF:
            continue  # repeated stream identifier
        elif 0x80 <= ctype <= 0xFE:
            continue  # skippable (0xFE = padding)
        else:
            raise SnappyError(f"unknown chunk type {ctype:#x}")
    return bytes(out)
