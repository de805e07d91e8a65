"""The device plumbing that every backend shares: which device a call runs
on, how a host array reaches it, and the lock that serialises the device
work of concurrent calls on it.

`resolve_device` turns a caller's `device=` into a `torch.device` and
raises when "cuda" is asked for with no GPU present: nothing falls back to
the CPU. `to_device` ships a host array through a pinned staging copy,
non-blocking, so the host goes on while the card still runs the kernels
queued before it. `device_lock` is one re-entrant lock per device, taken
around an attempt's uploads, launches and reads by the BLS and the KZG
backends alike, so their calls launch one after another, each on the
current stream of the thread that holds the lock.
"""

import threading

import numpy as np
import torch

_locks_guard = threading.Lock()
_device_locks: dict = {}


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on the CPU as it is; on the card through a
    pinned staging copy, non-blocking (a copy from pageable memory would
    wait for the queued kernels)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def device_lock(dev: torch.device) -> threading.RLock:
    """The lock that serialises the device work of concurrent calls on
    `dev`."""
    with _locks_guard:
        return _device_locks.setdefault(str(dev), threading.RLock())
