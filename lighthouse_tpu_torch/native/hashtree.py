"""The native batch SHA-256 of the SSZ Merkleization (hashtree.c), with
the hashlib path beside it.

`hashtree.c` is a CPython extension module; it is compiled at first use
with the system's C compiler into `lighthouse_tpu_torch/build/` (as
`g2decomp.c` is) and loaded from there. When it cannot be built or loaded,
`hash_pairs` runs hashlib, which gives the same digests.
"""

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading

_HERE = os.path.dirname(__file__)
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SRC = os.path.join(_HERE, "hashtree.c")
_SO = os.path.join(_BUILD, "_hashtree" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))

_mod = None
_mod_failed = False
_mod_lock = threading.Lock()


def build(force: bool = False) -> bool:
    """Compile the extension with cc; returns True on success."""
    try:
        fresh = os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    except OSError:
        fresh = os.path.exists(_SO)
    if fresh and not force:
        return True
    os.makedirs(_BUILD, exist_ok=True)
    # build under a per-process name, then rename: concurrent test
    # workers must never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    include = sysconfig.get_paths()["include"]
    cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{include}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    global _mod, _mod_failed
    if _mod is not None or _mod_failed:
        return _mod
    with _mod_lock:
        if _mod is not None or _mod_failed:
            return _mod
        if not build():
            _mod_failed = True
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader("_hashtree", _SO)
            spec = importlib.util.spec_from_file_location("_hashtree", _SO, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except ImportError:
            _mod_failed = True
            return None
        _mod = mod
        return _mod


def available() -> bool:
    return _load() is not None


def hash_pairs(data: bytes) -> bytes:
    """SHA-256 of each consecutive 64-byte block -> concatenated digests."""
    mod = _load()
    if mod is not None:
        return mod.hash_pairs(data)
    out = bytearray()
    for i in range(0, len(data), 64):
        out += hashlib.sha256(data[i : i + 64]).digest()
    return bytes(out)
