"""ctypes binding for the native point-decompression square roots
(g2decomp.c) with transparent fallback to the pure-Python path.

`g2_sqrt_rhs(x0, x1) -> (y0, y1) | None` and `g1_sqrt_rhs(x) -> y | None`
solve y^2 = x^3 + B over Fp2 / Fp — the ~5 ms/signature cost of
pure-Python decompression (bls/point_serde.py), reduced to ~30 µs of C.
"""

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(_BUILD, "_g2decomp.so")
_SRC = os.path.join(_HERE, "g2decomp.c")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def build(force: bool = False) -> bool:
    try:
        fresh = os.path.exists(_SO) and os.path.getmtime(
            _SO
        ) >= os.path.getmtime(_SRC)
    except OSError:
        # source missing alongside a prebuilt .so: use what exists
        fresh = os.path.exists(_SO)
    if fresh and not force:
        return True
    os.makedirs(_BUILD, exist_ok=True)
    # build under a per-process name, then rename: concurrent test
    # workers must never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["cc", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
    # built on the machine that runs it, so native tuning is safe; fall
    # back to portable flags if the compiler rejects it
    for cmd in (base[:1] + ["-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _SO)
            return True
        except (subprocess.CalledProcessError, OSError):
            continue
    return False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not build():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _lib_failed = True
            return None
        lib.lh_g2_sqrt_rhs.restype = ctypes.c_int
        lib.lh_g2_sqrt_rhs.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.lh_g1_sqrt_rhs.restype = ctypes.c_int
        lib.lh_g1_sqrt_rhs.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.lh_g1_in_subgroup.restype = ctypes.c_int
        lib.lh_g1_in_subgroup.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.lh_g2_in_subgroup.restype = ctypes.c_int
        lib.lh_g2_in_subgroup.argtypes = [ctypes.c_char_p]
        # eighth-roots init happens lazily inside the library; prime it
        # here (single-threaded) so concurrent callers never race it
        probe = ctypes.create_string_buffer(96)
        lib.lh_g2_sqrt_rhs(b"\x00" * 96, probe)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def g2_sqrt_rhs(x0: int, x1: int):
    """(y0, y1) with y^2 = x^3 + 4(1+u), or None if x is not on the
    curve; None also when the native library is unavailable (caller
    falls back to Python)."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(96)
    ok = lib.lh_g2_sqrt_rhs(
        x0.to_bytes(48, "big") + x1.to_bytes(48, "big"), buf
    )
    if not ok:
        return False  # distinguishes "not on curve" from "no library"
    raw = buf.raw
    return (
        int.from_bytes(raw[:48], "big"),
        int.from_bytes(raw[48:], "big"),
    )


def g1_in_subgroup(x: int, y: int):
    """[r]P == inf for affine G1 (x, y); None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    return bool(
        lib.lh_g1_in_subgroup(
            x.to_bytes(48, "big"), y.to_bytes(48, "big")
        )
    )


def g2_in_subgroup(x, y):
    """[r]P == inf for affine G2 ((x0,x1), (y0,y1)); None when
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    return bool(
        lib.lh_g2_in_subgroup(
            x[0].to_bytes(48, "big")
            + x[1].to_bytes(48, "big")
            + y[0].to_bytes(48, "big")
            + y[1].to_bytes(48, "big")
        )
    )


def g1_sqrt_rhs(x: int):
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(48)
    ok = lib.lh_g1_sqrt_rhs(x.to_bytes(48, "big"), buf)
    if not ok:
        return False
    return int.from_bytes(buf.raw, "big")
