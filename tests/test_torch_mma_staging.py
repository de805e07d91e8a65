"""The tensor-core probe's staging of X[s] (csrc/mma_probe.cu `stage_t`) on
the CPU: the `__byte_perm` selectors, read from the source, transpose 4 x 4
int8 blocks and 2 x 2 bf16 blocks exactly as numpy does. The kernel itself
runs only on the card (chip_smoke.py)."""

import os
import re

import numpy as np
import pytest

from lighthouse_tpu_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "mma_probe.cu")


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4 n) & 7 of
    the 8 bytes y:x."""
    pool = x | y << 32
    return sum(((pool >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def _stage_body(kind):
    text = open(SOURCE).read()
    sig = "const int8_t* X" if kind == "i8" else "const __nv_bfloat16* X"
    start = text.index(sig)
    return text[start:text.index("\n}\n", start)]


def _selectors(body):
    return [(a, b, int(s, 16)) for a, b, s in
            re.findall(r"__byte_perm\((\w+), (\w+), (0x[0-9a-f]+)\)", body)]


def test_byte_perm_model():
    assert byte_perm(0x03020100, 0x07060504, 0x3210) == 0x03020100
    assert byte_perm(0x03020100, 0x07060504, 0x7654) == 0x07060504
    assert byte_perm(0x03020100, 0x07060504, 0x5140) == 0x05010400


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_blocks_transpose(seed):
    sel = _selectors(_stage_body("i8"))
    assert len(sel) == 8
    env = {}
    rows = np.random.default_rng(seed).integers(0, 256, (4, 4), dtype=np.uint8)  # [l][b]
    for i in range(4):
        env[f"r{i}"] = int(rows[i].view("<u4")[0])
    for name, (a, b, s) in zip(("lo01", "lo23", "hi01", "hi23"), sel[:4]):
        env[name] = byte_perm(env[a], env[b], s)
    cols = [byte_perm(env[a], env[b], s) for a, b, s in sel[4:]]  # columns b .. b + 3
    got = np.array([np.array([c], "<u4").view(np.uint8) for c in cols])
    assert np.array_equal(got, rows.T)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_blocks_transpose(seed):
    sel = _selectors(_stage_body("bf16"))
    assert len(sel) == 2
    rows = np.random.default_rng(seed).integers(0, 1 << 16, (2, 2), dtype=np.uint16)  # [l][b]
    env = {f"r{i}": int(rows[i].view("<u4")[0]) for i in range(2)}
    cols = [byte_perm(env[a], env[b], s) for a, b, s in sel]
    got = np.array([np.array([c], "<u4").view(np.uint16) for c in cols])
    assert np.array_equal(got, rows.T)
