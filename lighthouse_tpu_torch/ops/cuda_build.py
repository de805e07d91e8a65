"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each source under `lighthouse_tpu_torch/csrc/` (one per kernel family; K1,
K2, K3, the helpers, the subgroup check and the Fp product's timing include
the register arithmetic of `fp_reg.cuh`, K2, K3 and the product through
`lanes.cuh`)
compiles at first use into its own shared library with a plain C
interface under `lighthouse_tpu_torch/build/`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

`build_all()` starts one nvcc per stale source at once and waits for all;
what ptxas reports (registers, stack frame, spills) is kept beside each
library as `<name>.ptxas.txt`. A C entry returns `cudaGetLastError()`
after its launch and `launch()` raises on anything but 0: a refused launch
never falls back to anything.

`LAUNCHES` counts, per kernel, the launches made through the wrappers;
`time_ms` times a call's device work on the card with CUDA events, the
calls queued behind a device-side sleep so that the host's wrapper work
stays outside the events; `call_ms` times one synchronised call with the
wrapper's host work inside, to show that share.
"""

import ctypes
import glob
import os
import re
import shutil
import statistics
import subprocess
import threading
import time

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")

_P = ctypes.c_void_p
_I = ctypes.c_int

# source -> {C entry -> argument types}
SOURCES = {
    "ladder": {
        "lh_ladder_g1": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "lh_ladder_g2": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "lh_ladder_g1_chain": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "lh_ladder_g2_chain": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "lh_ladder_g1_w2": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "lh_ladder_g2_w2": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    },
    "miller": {"lh_miller": [_P, _P, _P, _P, _P, _I, _P, _P]},
    "final_exp": {
        "lh_fold_final_exp": [_P, _I, _P, _P, _P, _P, _P],
        "lh_pair_final_exp": [_P, _I, _P, _P, _P],
    },
    "fp_product": {"lh_fp_chain": [_P, _P, _I, _I, _P, _P]},
    "curve_helpers": {
        "lh_lane_fold_g1": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "lh_lane_fold_g2": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "lh_to_affine_g1": [_P, _P, _P, _I, _P, _P, _P, _P],
        "lh_to_affine_g2": [_P, _P, _P, _I, _P, _P, _P, _P],
        "lh_jacobian_to_affine_g1": [_P, _P, _P, _I, _P, _P, _P, _P],
        "lh_jacobian_to_affine_g2": [_P, _P, _P, _I, _P, _P, _P, _P],
    },
    "mma_probe": {
        "lh_mma_probe_i8": [_P, _P, _I, _I, _I, _I, _P, _P],
        "lh_mma_probe_bf16": [_P, _P, _I, _I, _I, _I, _P, _P],
    },
    "subgroup": {"lh_g2_subgroup": [_P, _P, _P, _I, _P, _P], "lh_g2_subgroup_blocks_per_sm": [_P, _P]},
}

# kernel name -> launches through its wrapper
LAUNCHES = {
    "ladder_g1": 0,
    "ladder_g2": 0,
    "ladder_g1_chain": 0,
    "ladder_g2_chain": 0,
    "ladder_g1_w2": 0,
    "ladder_g2_w2": 0,
    "miller": 0,
    "fold_final_exp": 0,
    "pair_final_exp": 0,
    "lane_sum_g1": 0,
    "lane_sum_g2": 0,
    "to_affine_g1": 0,
    "to_affine_g2": 0,
    "jacobian_to_affine_g1": 0,
    "jacobian_to_affine_g2": 0,
    "mma_probe_i8": 0,
    "mma_probe_bf16": 0,
    "subgroup_g2": 0,
}

# source -> {"seconds": build time, "ptxas": ptxas -v report}
BUILD_LOG: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_version() -> str:
    """nvcc's release line, e.g. 'Cuda compilation tools, release 12.8, V12.8.93'."""
    out = subprocess.run([nvcc_path(), "--version"], check=True, capture_output=True, text=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if "release" in ln]
    return lines[0] if lines else out.stdout.strip()


def lib_path(source: str) -> str:
    return os.path.join(BUILD, f"lib{source}.so")


def _stale(source: str) -> bool:
    so = lib_path(source)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    deps = [os.path.join(CSRC, f"{source}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(d) > built for d in deps)


def _command(source: str, out: str) -> list:
    return [
        nvcc_path(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", out,
        os.path.join(CSRC, f"{source}.cu"),
    ]


def build_all(force: bool = False) -> dict:
    """Compile every stale source, one nvcc each, all at once; raise with
    the compiler's output if any fails. Returns BUILD_LOG."""
    os.makedirs(BUILD, exist_ok=True)
    todo = [s for s in SOURCES if force or _stale(s)]
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        tmp = f"{lib_path(s)}.{os.getpid()}.tmp"
        procs[s] = (
            subprocess.Popen(
                _command(s, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            ),
            tmp,
        )
    failed = []
    for s, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[s] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": (out or "") + (err or ""),
        }
        if proc.returncode != 0:
            failed.append(f"{s}.cu:\n{out}{err}")
            continue
        os.replace(tmp, lib_path(s))
        with open(os.path.join(BUILD, f"{s}.ptxas.txt"), "w") as f:
            f.write(BUILD_LOG[s]["ptxas"])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return BUILD_LOG


def ptxas_summary(text: str) -> dict:
    """ptxas -v output -> {kernel: {"registers", "stack_bytes",
    "shared_bytes"}} for the entry functions (static shared memory; a
    kernel's dynamic shared memory is the launch's), the spill bytes summed
    over every function, and each function's own frame and spills under
    "functions"."""
    kernels, functions = {}, {}
    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            functions[props] = {"stack_frame": int(m.group(1)), "spill_stores": int(m.group(2)),
                                "spill_loads": int(m.group(3))}
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            stack = re.search(r"(\d+) bytes cumulative stack size", line)
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[entry] = {"registers": int(m.group(1)),
                              "stack_bytes": int(stack.group(1)) if stack else 0,
                              "shared_bytes": int(smem.group(1)) if smem else 0}
            entry = None
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    return {
        "kernels": kernels,
        "functions": functions,
        "spill_store_bytes": sum(int(a) for a, _ in spills),
        "spill_load_bytes": sum(int(b) for _, b in spills),
    }


def library(source: str):
    """The loaded library of `source`, built first if stale."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        if source not in _libs:
            if _stale(source):
                build_all()
            lib = ctypes.CDLL(lib_path(source))
            for fn, argtypes in SOURCES[source].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[source] = lib
    return _libs[source]


def check(t, name: str, shape=None, device=None, dtype=torch.int32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (int32 unless
    said otherwise) and `shape` (None entries match any size) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        ok = len(shape) == t.dim() and all(
            s is None or s == d for s, d in zip(shape, t.shape)
        )
        if not ok:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def use_kernel(t, require_kernel: bool) -> bool:
    """The wrappers' one dispatch rule: a CUDA tensor launches the kernel,
    a CPU tensor runs the plain version -- unless the caller demands the
    kernel, which a CPU tensor cannot have."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    if require_kernel:
        raise ValueError("the CUDA kernel was requested for a CPU tensor")
    return False


def call(source: str, fn: str, *args) -> None:
    """Call C entry `fn` of `source` (tensors become device pointers, the
    current stream is appended); raise unless it returns 0."""
    lib = library(source)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def launch(source: str, fn: str, kernel: str, *args) -> None:
    """`call`, and count one launch of `kernel`."""
    call(source, fn, *args)
    LAUNCHES[kernel] += 1


# cycles a second that `torch.cuda._sleep` is asked for: at least the
# card's clock, so a sleep lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2.0e9


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device-side timing needs a CUDA device")


def _queued_ms(fn, calls: int) -> float:
    """Device ms of one call: `calls` calls queued behind a device-side
    sleep, bracketed by one event pair. The sleep holds the device until
    the host has queued every call, so the host's wrapper work (checks,
    allocation, the ctypes call) overlaps queued device work and the events
    bracket device work alone; if the device reached the first event before
    the host had queued the last call, the sleep is lengthened and the run
    repeated."""
    sleep_s = 2e-3
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        end.record()
        host_s = time.perf_counter() - t0
        reached = start.query()
        torch.cuda.synchronize()
        if not reached:
            return start.elapsed_time(end) / calls
        sleep_s = 2 * host_s + 2e-3
    raise RuntimeError("time_ms: the host could not queue the calls ahead of the device")


def time_ms(fn, reps: int = 3) -> float:
    """Device time of one call of `fn` in ms, without the host's wrapper
    work: the median over `reps` runs of back-to-back calls queued behind a
    device-side sleep (`_queued_ms`), each run as many calls as fill about
    a millisecond (at most 200), after one warm-up call. Needs a CUDA
    device; `fn` must not synchronise."""
    _need_cuda()
    fn()
    torch.cuda.synchronize()
    one = _queued_ms(fn, 1)
    calls = max(1, min(200, int(1.0 / max(one, 1e-3))))
    return statistics.median(_queued_ms(fn, calls) for _ in range(reps))


def call_ms(fn, reps: int = 3) -> float:
    """The median CUDA-event time of one synchronised call of `fn`, the
    start event recorded on an idle device before the wrapper runs, so the
    wrapper's host work is inside the interval: beside `time_ms`, it shows
    the host's share of a short call."""
    _need_cuda()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
