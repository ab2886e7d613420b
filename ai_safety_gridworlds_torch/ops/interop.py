"""Carry packed states and kernel constants between the JAX package and the
port, as numpy arrays.

The JAX package's packed state (``init_packed`` output, or any state it
reached) comes in with :func:`state_from_numpy` and goes back with
:func:`state_to_numpy`; dtypes (``uint32`` keys included) are kept.
:func:`busy_firemaker_state`, :func:`busy_scalar_state` and
:func:`busy_island_ma_state` make seeded mid-episode states to compare
implementations from. :func:`params_from_numpy` and :func:`params_to_numpy`
carry the MLP policy's params, so that both packages run the same policy.
:func:`assert_consts_equal` checks that a port kernel's ``consts`` equal the
JAX kernel's key by key.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_safety_gridworlds_torch.ops.fused_base import MLP_KEYS


def state_from_numpy(S_np: dict, device) -> dict:
    """numpy ``[rows, B]`` arrays -> contiguous tensors on ``device``."""
    return {
        k: torch.from_numpy(np.array(v, order="C")).to(device)
        for k, v in S_np.items()
    }


def state_to_numpy(S: dict) -> dict:
    """Tensors -> numpy arrays on the host, dtypes kept."""
    return {k: v.detach().cpu().numpy() for k, v in S.items()}


def busy_firemaker_state(fused, seed: int, batch: int, device) -> dict:
    """A numpy-seeded mid-episode firemaker state on ``device``, for holding
    two implementations of the step against each other away from
    ``init_packed``: burning spreadable cells, a busy stop-button countdown
    and external-fire count, visit counts, workshop flags and reward sums,
    agents on random distinct free cells in every other lane, and draw
    counters anywhere in uint32, every other lane within 64 of the wrap."""
    rng = np.random.default_rng(seed)
    S = state_to_numpy(fused.init_packed(seed, batch, "cpu"))
    n, HW = fused.n, fused.HW
    spreadable = fused.consts["spreadable"][:, 0] > 0.5
    S["fire"] = (
        (rng.random((HW, batch)) < 0.2) & spreadable[:, None]
    ).astype(np.float32)
    S["countdown"] = rng.integers(0, 5, (1, batch)).astype(np.int32)
    S["ext_fires"] = rng.integers(0, 3, (1, batch)).astype(np.int32)
    S["visits"] = rng.integers(0, 4, S["visits"].shape).astype(np.int32)
    S["at_workshop"] = rng.integers(0, 2, (n, batch)).astype(np.float32)
    S["stats_rewards"] = rng.integers(
        -5, 6, S["stats_rewards"].shape
    ).astype(np.float32)
    S["t"] = (n * rng.integers(0, fused.max_iterations // n, (1, batch))).astype(
        np.int32
    )
    ctr = rng.integers(0, 2**32, (1, batch), dtype=np.uint32)
    ctr[:, ::2] = rng.integers(2**32 - 64, 2**32, (1, (batch + 1) // 2),
                               dtype=np.uint32)
    S["draw_ctr"] = ctr
    free = np.flatnonzero(fused.consts["wall"][:, 0] < 0.5)
    for b in range(0, batch, 2):
        S["pos"][:, b] = rng.choice(free, size=n, replace=False)
    for k in ("act_dir", "obs_dir"):
        if k in S:
            S[k] = rng.integers(0, 4, (n, batch)).astype(np.int32)
    return state_from_numpy(S, device)


def busy_scalar_state(fused, seed: int, batch: int, device) -> dict:
    """A numpy-seeded mid-episode state of a fused scalar env on ``device``:
    agents on random open cells (cells that end an episode only in lanes
    about to reset), ``t`` near ``max_iterations`` in every other lane and
    anywhere below it in the others, one lane in eight in LAST (it resets
    on the next step), nonzero returns and stats, visit counts up to 4 on
    the open cells of boat_race_ex's board, and draw counters anywhere in
    uint32, every other lane within 64 of the wrap."""
    rng = np.random.default_rng(seed)
    S = state_to_numpy(fused.init_packed(seed, batch, "cpu"))
    st = fused._kstatics_np
    open_cells = st["wall"][:, 0] < 0.5
    ending = np.zeros_like(open_cells)
    for k in ("water", "goal", "ongoal"):
        if k in st:
            ending |= st[k][:, 0] > 0.5
    last = rng.random(batch) < 0.125
    safe = np.flatnonzero(open_cells & ~ending)
    anywhere = np.flatnonzero(open_cells)
    S["pos"][0] = np.where(
        last, rng.choice(anywhere, batch), rng.choice(safe, batch)
    )
    T = fused.max_iterations
    t = rng.integers(1, T, batch)
    t[::2] = rng.integers(max(1, T - 8), T + 1, (batch + 1) // 2)
    S["step_types"][0] = np.where(last | (t >= T), 2, 1)
    S["t"][0] = t
    D = fused.D
    S["ep_ret"] = rng.integers(-30, 30, (D, batch)).astype(np.float32)
    S["hid_ret"] = rng.integers(-20, 20, (1, batch)).astype(np.float32)
    S["stats_episodes"] = rng.integers(0, 40, (1, batch)).astype(np.int32)
    S["stats_return"] = rng.integers(-900, 900, (D, batch)).astype(np.float32)
    S["stats_hidden"] = rng.integers(-300, 300, (1, batch)).astype(np.float32)
    S["stats_rewards"] = rng.integers(-2000, 2000, (D, batch)).astype(
        np.float32
    )
    ctr = rng.integers(0, 2**32, (1, batch), dtype=np.uint32)
    ctr[:, ::2] = rng.integers(2**32 - 64, 2**32, (1, (batch + 1) // 2),
                               dtype=np.uint32)
    S["draw_ctr"] = ctr
    if "safety" in S:
        S["safety"][0] = st["wdist"][S["pos"][0], 0]
    if "visits" in S:
        visits = rng.integers(0, 5, S["visits"].shape).astype(np.float32)
        visits *= open_cells[:, None]
        lanes = np.arange(batch)
        visits[S["pos"][0], lanes] = np.maximum(visits[S["pos"][0], lanes], 1)
        S["visits"] = visits
    return state_from_numpy(S, device)


def busy_island_ma_state(fused, seed: int, batch: int, device) -> dict:
    """A numpy-seeded mid-episode island_navigation_ex_ma state on
    ``device``. It first calls ``fused.init_packed(seed, batch, "cpu",
    layout_pool=fused.layout_pool)``, which draws the layouts (the same
    ones as the JAX package's ``init_packed`` from that seed). Then: agents
    on distinct random non-wall cells of their lane's current layout
    (water, drink, food, gold and silver included) with their cached tile
    values; satiations from -22 to 6, on both sides of the deficiency and
    oversatiation thresholds and at the death limits; availabilities 0 to
    20 with nonzero fractions; random facings, safety, visits and stats;
    one lane in eight with a dead agent and one in eight with all agents
    dead (it resets on the next step); ``t`` near ``max_iterations`` in
    every other lane; draw counters anywhere in uint32, every other lane
    within 64 of the wrap; and, with a layout pool, episode counters 0..5."""
    rng = np.random.default_rng(seed)
    S = state_to_numpy(fused.init_packed(seed, batch, "cpu",
                                         layout_pool=fused.layout_pool))
    n, K = fused.n, fused.layout_pool
    st = fused._kstatics_np
    if K > 1:
        S["ep_idx"] = rng.integers(0, 6, (1, batch)).astype(np.int32)
    for b in range(batch):
        k = int(S["ep_idx"][0, b]) % K if K > 1 else 0
        sfx = f"_p{k}" if k else ""
        lane = b if st["wall" + sfx].shape[1] > 1 else 0
        free = np.flatnonzero(st["wall" + sfx][:, lane] < 0.5)
        S["pos"][:, b] = rng.choice(free, size=n, replace=False)
        S["vcode"][:, b] = st["sboard" + sfx][S["pos"][:, b], lane]
    S["safety"] = rng.integers(0, 6, (n, batch)).astype(np.int32)
    for k in ("act_dir", "obs_dir"):
        S[k] = rng.integers(0, 4, (n, batch)).astype(np.int32)
    for k in ("drink_sat", "food_sat"):
        S[k] = rng.integers(-22, 7, (n, batch)).astype(np.float32)
    for k in ("drink_avail", "food_avail"):
        S[k] = rng.integers(0, 21, (1, batch)).astype(np.float32)
    for k in ("drink_frac", "food_frac"):
        S[k] = rng.uniform(0.01, 0.99, (1, batch)).astype(np.float32)
    S["visits"] = rng.integers(0, 5, S["visits"].shape).astype(np.int32)
    S["stats_rewards"] = rng.integers(
        -300, 300, S["stats_rewards"].shape
    ).astype(np.float32)
    S["stats_episodes"] = rng.integers(0, 30, (1, batch)).astype(np.int32)
    T = fused.max_iterations
    t = rng.integers(0, T, batch)
    t[::2] = rng.integers(max(0, T - 4), T, (batch + 1) // 2)
    S["t"][0] = t
    # Step types and termination reasons: alive agents are MID, dead ones
    # TERMINATED and LAST or DEAD; "one" lanes have one dead agent, "all"
    # lanes only dead ones.
    kind = rng.random(batch)
    S["step_types"][:] = 1
    S["reasons"][:] = -1
    for b in np.flatnonzero(kind < 0.25):
        dead = (np.arange(n) == rng.integers(0, n)) if kind[b] < 0.125 else (
            np.ones(n, bool)
        )
        S["reasons"][dead, b] = 0
        S["step_types"][dead, b] = rng.choice([2, 3], size=int(dead.sum()))
    ctr = rng.integers(0, 2**32, (1, batch), dtype=np.uint32)
    ctr[:, ::2] = rng.integers(2**32 - 64, 2**32, (1, (batch + 1) // 2),
                               dtype=np.uint32)
    S["draw_ctr"] = ctr
    return state_from_numpy(S, device)


def params_from_numpy(p_np: dict, device) -> dict:
    """MLP params as numpy (the JAX package's ``ppo_fused.init_params``
    layout: ``mlp_w1`` [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1, H],
    ``mlp_b2`` [A+1, 1]) -> contiguous float32 tensors on ``device``."""
    return {
        k: torch.from_numpy(np.array(p_np[k], np.float32, order="C")).to(device)
        for k in MLP_KEYS
    }


def params_to_numpy(params: dict) -> dict:
    """MLP param tensors -> float32 numpy arrays on the host."""
    return {k: params[k].detach().cpu().numpy() for k in MLP_KEYS}


def assert_consts_equal(port_consts: dict, jax_consts: dict) -> None:
    """Raise ``AssertionError`` unless the two constant dicts hold the same
    keys with equal shapes, dtypes and values.

    The reference splits its log-survival matrix into bf16-exact
    ``spread_logw_hi`` and a residual ``spread_logw_lo`` for the TPU's matrix
    unit; the port keeps one float32 ``spread_logw``, compared with
    ``hi + lo`` (exactly the float32 matrix)."""
    ref = {k: np.asarray(v) for k, v in jax_consts.items()}
    if "spread_logw_hi" in ref:
        ref["spread_logw"] = (
            ref.pop("spread_logw_hi") + ref.pop("spread_logw_lo")
        )
    if set(port_consts) != set(ref):
        raise AssertionError(
            f"const keys differ: port-only {sorted(set(port_consts) - set(ref))}, "
            f"reference-only {sorted(set(ref) - set(port_consts))}"
        )
    for k, want in ref.items():
        got = np.asarray(port_consts[k])
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(
                f"const {k!r}: {got.dtype}{got.shape} vs {want.dtype}{want.shape}"
            )
        if not np.array_equal(got, want):
            raise AssertionError(f"const {k!r} values differ")
