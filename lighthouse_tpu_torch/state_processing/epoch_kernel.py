"""The altair epoch pass on the card: inactivity updates, then rewards and
penalties, as one pass over (V,) arrays.

The port of `lighthouse_tpu/state_processing/epoch_kernel.py`. The spec
applies process_inactivity_updates before process_rewards_and_penalties,
and the inactivity penalty reads the UPDATED scores; the three per-flag
participating balances are sums over (V,). Everything is int64 with floor
division, so the pass equals the spec's Python loops exactly inside the
int64 envelope that `run_inactivity_and_rewards` checks on the host
before any launch (`eff * (score + bias) < 2**62`); outside it the caller
runs the spec's Python passes.

`rewards` is the kernel's wrapper: CUDA tensors launch
`csrc/epoch_rewards.cu` (the sums' reduction and the elementwise pass, two
launches of one C entry, counted as one), CPU tensors run `rewards_plain`.
The card has no 64-bit division, so the wrapper hands the kernel a magic
number for each of the epoch's divisors (`divisor_magic`), and the kernel
divides by a multiply-high and a floor correction (`floordiv_magic` models
it in Python ints); the reward denominator active_increments * 64 is formed
with int64 wrap (`reward_denominator`), as in the reference's jitted pass.
"""

import ctypes
import threading
import time

import numpy as np
import torch

from lighthouse_tpu_torch.ops import cuda_build, device_io

# participation flag weights (altair spec): source, target, head
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)
WEIGHT_DENOMINATOR = 64
# the scalars of a pass, in the order `rewards` takes them
PARAMS = ("base_per_inc", "increment", "active_increments", "leak", "score_bias",
          "score_recovery", "inactivity_denominator")
# an epoch far beyond any reachable one: FAR_FUTURE_EPOCH (2**64 - 1) does
# not fit int64, and comparisons with real epochs are unaffected
EPOCH_CLAMP = 2**62

# the host/device split of the last run_inactivity_and_rewards call, s
LAST_EPOCH_STATS: dict = {}

INT64_MIN = -(1 << 63)
U64 = (1 << 64) - 1
# csrc/epoch_rewards.cu: the words of its workspace (three sums, a
# done-counter, three scalars, one spare, a table of 3 x 64 rewards), kept
# a (device, stream) and left with its sums and counter at 0 by every call
WORKSPACE_WORDS = 8 + 3 * 64
_WORKSPACES: dict = {}
_workspaces_lock = threading.Lock()


def wrap64(v: int) -> int:
    """v as an int64 tensor holds it: two's complement wrap."""
    return ((v - INT64_MIN) & U64) + INT64_MIN


def reward_denominator(active_increments: int) -> int:
    """active_increments * WEIGHT_DENOMINATOR with int64 wrap, as the
    reference's jitted pass forms it."""
    return wrap64(active_increments * WEIGHT_DENOMINATOR)


def divisor_magic(d: int) -> tuple:
    """(m, v, sh1, sh2, neg) for a nonzero int64 divisor d: v = |d| and
    Granlund and Montgomery's round-up magic for unsigned 64-bit dividends
    (Hacker's Delight 10-8): with l = ceil(log2 v), m = floor(2^64 (2^l -
    v) / v) + 1 < 2^64, sh1 = min(l, 1), sh2 = max(l - 1, 0)."""
    if d == 0 or not INT64_MIN <= d <= -INT64_MIN - 1:
        raise ValueError(f"divisor {d}: not a nonzero int64")
    v = abs(d)
    ell = (v - 1).bit_length()
    m = (((1 << ell) - v) << 64) // v + 1
    assert 0 < m <= U64
    return m, v, min(ell, 1), max(ell - 1, 0), int(d < 0)


def floordiv_magic(a: int, magic: tuple) -> int:
    """The kernel's `floordiv` in Python ints: u = |a| as a uint64, t =
    mulhi(m, u), q = (t + ((u - t) >> sh1)) >> sh2 (= u // v, asserted),
    then q, or -q - (u != q v) where a and the divisor differ in sign,
    wrapped to int64: floor(a / d) for every int64 a."""
    m, v, sh1, sh2, neg = magic
    assert INT64_MIN <= a <= -INT64_MIN - 1
    u = -a if a < 0 else a
    t = (m * u) >> 64
    q = (t + ((u - t) >> sh1)) >> sh2
    assert q * v <= u < (q + 1) * v, "the magic's quotient is not u // v"
    if (a < 0) != bool(neg):
        return wrap64(-q - int(u != q * v))
    return wrap64(q)


def magic_words(magic: tuple) -> list:
    """A magic as the kernel's three int64 parameter words: m, v (each
    wrapped) and sh1 | sh2 << 8 | neg << 16."""
    m, v, sh1, sh2, neg = magic
    return [wrap64(m), wrap64(v), sh1 | sh2 << 8 | neg << 16]


def kernel_params(params) -> list:
    """The kernel's 16 parameter words: the seven scalars of PARAMS, then
    the magic words of the increment, of the reward denominator and of the
    inactivity denominator. Raises on a divisor the pass cannot take."""
    if len(params) != len(PARAMS):
        raise ValueError(f"params: expected {len(PARAMS)} scalars, got {len(params)}")
    scalars = [int(p) for p in params]
    for name, v in zip(PARAMS, scalars):
        if not INT64_MIN <= v <= -INT64_MIN - 1:
            raise ValueError(f"params: {name} = {v} is not an int64")
    increment, active_increments, denominator = scalars[1], scalars[2], scalars[6]
    if increment <= 0 or active_increments <= 0 or denominator <= 0:
        raise ValueError("params: increment, active_increments and the denominator must be > 0")
    if reward_denominator(active_increments) == 0:
        raise ValueError("params: active_increments * 64 wraps to 0 in int64")
    words = list(scalars)
    for d in (increment, reward_denominator(active_increments), denominator):
        words += magic_words(divisor_magic(d))
    return words


def _workspace(dev) -> torch.Tensor:
    """The kernel's zeroed workspace for `dev` and its current stream."""
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream)
    with _workspaces_lock:
        ws = _WORKSPACES.get(key)
        if ws is None:
            ws = _WORKSPACES[key] = torch.zeros(WORKSPACE_WORDS, dtype=torch.int64, device=dev)
    return ws


def plan(n: int, device) -> dict:
    """The kernel's grids at n validators with aligned arrays, as its C
    entry makes them (`lh_epoch_rewards_plan`): the sums pass's validators
    a thread (the elementwise pass takes one), the
    resident blocks an SM of the sums pass and of the elementwise pass
    that the CUDA runtime reports, the SMs, both grids and their waves."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = cuda_build.library("epoch_rewards").lh_epoch_rewards_plan(
            n, ctypes.addressof(out), None)
    if rc != 0:
        raise RuntimeError(f"lh_epoch_rewards_plan: CUDA error {rc}")
    vec, sums_sm, rewards_sm, sms, sums_blocks, rewards_blocks = list(out)
    return {"sums_validators_a_thread": vec, "threads": 256, "sums_blocks_per_sm": sums_sm,
            "rewards_blocks_per_sm": rewards_sm, "sms": sms, "sums_blocks": sums_blocks,
            "rewards_blocks": rewards_blocks, "rewards_waves": rewards_blocks / (rewards_sm * sms)}


def rewards_bytes(n: int) -> int:
    """Bytes the pass must move: three int64 inputs, the uint8 flags and
    three bool masks read once, two int64 outputs written once."""
    return n * (3 * 8 + 1 + 3 + 2 * 8)


def rewards_plain(eff, prev_part, scores, balances, active_prev, slashed, eligible, params):
    """The kernel's function in torch int64 on any device: the reference's
    `_kernel` (`//` on int64 tensors is floor division, like jnp's)."""
    base_per_inc, increment, active_increments, leak, bias, recovery, denominator = (
        int(p) for p in params)
    unslashed = active_prev & ~slashed
    base = (eff // increment) * base_per_inc

    # process_inactivity_updates (the old participation)
    target_part = unslashed & (((prev_part >> TIMELY_TARGET_FLAG_INDEX) & 1) != 0)
    new_scores = torch.where(target_part, scores - torch.clamp(scores, max=1), scores + bias)
    if not leak:
        new_scores = new_scores - torch.clamp(new_scores, max=recovery)
    new_scores = torch.where(eligible, new_scores, scores)

    # process_rewards_and_penalties
    rewards = torch.zeros_like(balances)
    penalties = torch.zeros_like(balances)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        part = unslashed & (((prev_part >> flag_index) & 1) != 0)
        part_balance = max(increment, int(torch.where(part, eff, 0).sum()))
        part_increments = part_balance // increment
        flag_reward = (base * weight * part_increments) // reward_denominator(active_increments)
        if not leak:
            rewards = rewards + torch.where(eligible & part, flag_reward, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = penalties + torch.where(
                eligible & ~part, (base * weight) // WEIGHT_DENOMINATOR, 0)
    # the inactivity penalty: UPDATED scores, non-target-participating
    penalties = penalties + torch.where(
        eligible & ~target_part, (eff * new_scores) // denominator, 0)
    new_balances = torch.clamp(balances + rewards - penalties, min=0)
    return new_balances, new_scores


def rewards(eff, prev_part, scores, balances, active_prev, slashed, eligible, params,
            require_kernel: bool = False):
    """(new_balances, new_scores), (V,) int64 each: CUDA tensors launch the
    kernel, CPU tensors run `rewards_plain`. eff, scores and balances are
    (V,) int64, prev_part the (V,) uint8 participation flags, the three
    masks (V,) bool; params the seven scalars of PARAMS."""
    if not cuda_build.use_kernel(eff, require_kernel):
        return rewards_plain(eff, prev_part, scores, balances, active_prev, slashed, eligible,
                             params)
    n = int(eff.shape[0])
    dev = eff.device
    for name, tensor in (("eff", eff), ("scores", scores), ("balances", balances)):
        cuda_build.check(tensor, name, (n,), dev, torch.int64)
    cuda_build.check(prev_part, "prev_part", (n,), dev, torch.uint8)
    for name, tensor in (("active_prev", active_prev), ("slashed", slashed),
                         ("eligible", eligible)):
        cuda_build.check(tensor, name, (n,), dev, torch.bool)
    host_params = torch.tensor(kernel_params(params), dtype=torch.int64)
    out_balances = torch.empty_like(balances)
    out_scores = torch.empty_like(scores)
    if n == 0:
        return out_balances, out_scores
    cuda_build.launch("epoch_rewards", "lh_epoch_rewards", "epoch_rewards", eff, prev_part,
                      scores, balances, active_prev, slashed, eligible, n, host_params,
                      _workspace(dev), out_balances, out_scores)
    return out_balances, out_scores


def _clamped(values, n):
    return np.fromiter((min(x, EPOCH_CLAMP) for x in values), dtype=np.int64, count=n)


def run_inactivity_and_rewards(state, spec, ctx, device="cuda") -> bool:
    """The pass that replaces process_inactivity_updates +
    process_rewards_and_penalties_altair, on `device` ("cuda": the kernel;
    "cpu": its plain version). Returns False, before any upload or launch,
    when the inputs fall outside the pass's int64 envelope (the caller then
    runs the spec's Python passes). LAST_EPOCH_STATS gets the split."""
    from lighthouse_tpu_torch.state_processing.helpers import (
        get_total_active_balance,
        integer_squareroot,
    )
    from lighthouse_tpu_torch.state_processing.per_epoch import (
        fork_of,
        is_in_inactivity_leak,
    )

    dev = device_io.resolve_device(device)
    V = len(state.validators)
    if V == 0:
        return True
    t0 = time.perf_counter()
    eff = np.fromiter((v.effective_balance for v in state.validators), dtype=np.int64, count=V)
    scores = np.asarray(state.inactivity_scores, dtype=np.int64)
    # int64 envelope: eff * (score + bias) must not overflow
    max_eff = int(eff.max())
    max_score = int(scores.max()) + spec.INACTIVITY_SCORE_BIAS
    if max_eff * max_score >= 2**62:
        return False

    prev = ctx.prev_epoch
    activation = _clamped((v.activation_epoch for v in state.validators), V)
    exit_ep = _clamped((v.exit_epoch for v in state.validators), V)
    withdrawable = _clamped((v.withdrawable_epoch for v in state.validators), V)
    slashed = np.fromiter((v.slashed for v in state.validators), dtype=bool, count=V)
    active_prev = (activation <= prev) & (prev < exit_ep)
    eligible = active_prev | (slashed & (prev + 1 < withdrawable))
    prev_part = np.asarray(state.previous_epoch_participation, np.uint8)
    balances = np.asarray(state.balances, dtype=np.int64)

    total = get_total_active_balance(state, spec)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    params = (
        increment * spec.BASE_REWARD_FACTOR // integer_squareroot(total),
        increment,
        total // increment,
        int(is_in_inactivity_leak(state, spec)),
        spec.INACTIVITY_SCORE_BIAS,
        spec.INACTIVITY_SCORE_RECOVERY_RATE,
        spec.INACTIVITY_SCORE_BIAS * spec.inactivity_penalty_quotient_for(fork_of(state, spec)),
    )
    t1 = time.perf_counter()
    arrays = [device_io.to_device(a, dev) for a in (eff, prev_part, scores, balances,
                                                    active_prev, slashed, eligible)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t2 = time.perf_counter()
    new_balances, new_scores = rewards(*arrays, params)
    sync()
    t3 = time.perf_counter()
    new_balances = new_balances.cpu().numpy()
    new_scores = new_scores.cpu().numpy()
    t4 = time.perf_counter()
    state.balances = new_balances.tolist()
    state.inactivity_scores = new_scores.tolist()
    t5 = time.perf_counter()
    LAST_EPOCH_STATS.clear()
    LAST_EPOCH_STATS.update(validators=V, device=str(dev), extract_s=t1 - t0, upload_s=t2 - t1,
                            kernel_s=t3 - t2, readback_s=t4 - t3, writeback_s=t5 - t4)
    return True
