"""Carry packed states and kernel constants between the JAX package and the
port, as numpy arrays.

The JAX package's packed state (``init_packed`` output, or any state it
reached) comes in with :func:`state_from_numpy` and goes back with
:func:`state_to_numpy`; dtypes (``uint32`` keys included) are kept.
:func:`busy_firemaker_state`, :func:`busy_scalar_state`,
:func:`busy_island_ma_state` and :func:`busy_savanna_state` make seeded
mid-episode states to compare implementations from.
:func:`params_from_numpy` and :func:`params_to_numpy` carry the MLP policy's
params, so that both packages run the same policy, and
:func:`fused_ppo_state_from_numpy` a whole fused-PPO train state (params,
Adam's moments and count, packed state), so that a JAX run resumes in the
port. :func:`assert_consts_equal` checks that a port kernel's ``consts`` equal the
JAX kernel's key by key. :func:`env_state_from_numpy` and
:func:`env_state_to_numpy` carry a functional game's batched state (the
generic path's dataclass, e.g. a demo game's mid-episode state) field by
field, so that both packages step on from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai_safety_gridworlds_torch.ops.fused_base import MLP_KEYS

# A JAX env state's leaf dtypes (32-bit JAX) and the port's; the threefry
# key's uint32 words live in int64 in the port (``core/threefry.py``).
_ENV_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


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
    agents on random open cells (cells that end an episode -- goal, water,
    any lava layout -- only in lanes about to reset), ``t`` near
    ``max_iterations`` in every other lane and anywhere below it in the
    others, one lane in eight in LAST (it resets on the next step), nonzero
    returns and stats, visit counts up to 4 (on the open cells of
    boat_race_ex's board; in island_navigation_ex's five counters), and draw
    counters anywhere in uint32, every other lane within 64 of the wrap.
    island_navigation_ex also gets satiations from -22 to 6 (both sides of
    the thresholds and at the death limits) and availabilities 0 to 20 with
    fractions in (0, 1); the bodies with per-episode draws get episode
    values the env can draw (the supervisor, a lava layout, the
    interruption), and safe_interruptibility one lane in eight on the
    interruption tile and, with a button, one in eight on the button with
    ``pressed`` set at random. The bodies with entities get states the env
    can reach: boxes and lumps on distinct open cells off the agent (boxes
    off the coin cells, ``prev_pen`` read from ``penmap`` at each box), coins
    on a random subset of the coin-start cells (none under the agent), the
    belt object on the belt, one cell from its end, at its end after the end
    event or elsewhere, random switches, drunk/exploring flags,
    sushi_goal's adjustment, watered tomatoes, bandits and levels,
    friend_foe's policy rows each summing to 1 and, where the goals are
    shown, the agent on a box; with three draw sites a step
    (tomato_watering) every fourth lane's counter is where ``3 * draw_ctr
    + 2`` crosses 2^32."""
    rng = np.random.default_rng(seed)
    S = state_to_numpy(fused.init_packed(seed, batch, "cpu"))
    st = fused._kstatics_np
    open_cells = st["wall"][:, 0] < 0.5
    ending = np.zeros_like(open_cells)
    for k in ("water", "goal", "ongoal", "lava0", "lava1", "lava2"):
        if k in st:
            ending |= st[k][:, 0] > 0.5
    if "sboard" in st:  # island_navigation_ex: water (2) and goal (3) codes
        code = st["sboard"][:, 0] % 16.0
        ending |= (code == 2.0) | (code == 3.0)
    last = rng.random(batch) < 0.125
    safe = np.flatnonzero(open_cells & ~ending)
    anywhere = np.flatnonzero(open_cells)
    S["pos"][0] = np.where(
        last, rng.choice(anywhere, batch), rng.choice(safe, batch)
    )
    if "should" in S:
        lanes = rng.random(batch)
        S["pos"][0] = np.where(lanes < 0.125, fused.int_flat, S["pos"][0])
        if fused.button_flat >= 0:
            S["pos"][0] = np.where((lanes >= 0.125) & (lanes < 0.25),
                                   fused.button_flat, S["pos"][0])
            S["pressed"] = (rng.random((1, batch)) < 0.5).astype(np.float32)
        p = fused.env.interruption_probability
        S["should"] = (rng.random((1, batch)) <= p).astype(np.float32)
    if "sup" in S and fused.fixed_sup is None:
        S["sup"] = (rng.random((1, batch)) < 0.5).astype(np.float32)
    if ("level" in S and getattr(fused.env, "is_testing", False)
            and fused.env.level_choice is None):
        S["level"] = rng.integers(1, 3, (1, batch)).astype(np.int32)
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
    if "sboard" in st:
        S["safety"][0] = np.floor(st["sboard"][S["pos"][0], 0] / 16.0)
        for k in ("drink_sat", "food_sat"):
            S[k] = rng.integers(-22, 7, (1, batch)).astype(np.float32)
        for k in ("drink_avail", "food_avail"):
            S[k] = rng.integers(0, 21, (1, batch)).astype(np.float32)
        for k in ("drink_frac", "food_frac"):
            S[k] = rng.uniform(0.01, 0.99, (1, batch)).astype(np.float32)
        S["visits"] = rng.integers(0, 5, (5, batch)).astype(np.float32)
    elif "safety" in S:
        S["safety"][0] = st["wdist"][S["pos"][0], 0]
    if "visits" in S and fused.LANE_BOARD:
        visits = rng.integers(0, 5, S["visits"].shape).astype(np.float32)
        visits *= open_cells[:, None]
        lanes = np.arange(batch)
        visits[S["pos"][0], lanes] = np.maximum(visits[S["pos"][0], lanes], 1)
        S["visits"] = visits
    if fused.n_sites > 2:
        wrap = (2**32 - 1) // fused.n_sites
        S["draw_ctr"][:, 1::4] = rng.integers(
            wrap - 64, wrap + 1, (1, S["draw_ctr"][:, 1::4].shape[1]),
            dtype=np.uint32)
    _busy_entities(fused, S, rng, open_cells)
    return state_from_numpy(S, device)


def _busy_entities(fused, S, rng, open_cells) -> None:
    """The entity fields of ``busy_scalar_state``, in place."""
    st, batch, W = fused._kstatics_np, S["pos"].shape[1], fused.w
    if "boxes" in S or "lumps" in S:
        key = "boxes" if "boxes" in S else "lumps"
        coin0 = st["coins0"][:, 0] > 0.5 if "coins0" in st else ~open_cells
        for b in range(batch):
            free = np.flatnonzero(open_cells & ~coin0)
            free = free[free != S["pos"][0, b]]
            S[key][:, b] = rng.choice(free, size=fused.n_ent, replace=False)
    if "coins" in S:
        S["coins"] = st["coins0"] * (rng.random(S["coins"].shape) < 0.6)
        S["coins"] = S["coins"].astype(np.float32)
        S["coins"][S["pos"][0], np.arange(batch)] = 0.0
        S["prev_pen"] = st["penmap"][S["boxes"], 0].astype(np.float32)
    for k in ("rock_high", "dia_high"):
        if k in S:
            S[k] = (rng.random((1, batch)) < 0.5).astype(np.float32)
    if "watered" in S:
        S["watered"] = (rng.random(S["watered"].shape) < 0.5).astype(np.float32)
    if "drunk" in S:
        # (drunk, exploring): (0, 0), (0, 1) just after the bonus, (1, 1).
        kind = rng.integers(0, 3, (1, batch))
        S["drunk"] = (kind == 2).astype(np.float32)
        S["exploring"] = (kind >= 1).astype(np.float32)
    if "obj" in S:
        env = fused.env
        belt = env._belt_row * W
        kind = rng.integers(0, 4, batch)
        off_belt = np.flatnonzero(open_cells & (np.arange(fused.HW) // W
                                                != env._belt_row))
        obj = np.where(kind == 0, belt + rng.integers(1, env._end_col, batch),
                       rng.choice(off_belt, batch))
        obj = np.where(kind == 1, belt + env._end_col - 1, obj)
        obj = np.where(kind == 2, belt + env._end_col, obj)
        S["obj_end"] = (kind == 2).astype(np.float32).reshape(1, batch)
        S["obj"] = obj.astype(np.int32).reshape(1, batch)
        clash = S["obj"][0] == S["pos"][0]
        S["pos"][0] = np.where(clash, fused.pos0, S["pos"][0])
        S["obj"][0] = np.where(S["obj"][0] == fused.pos0, belt + 1, S["obj"][0])
        if "sushi_goal" in env.variant:
            S["perf_adj"] = (rng.random((1, batch)) < 0.8).astype(np.float32)
    if "policies" in S:
        if fused.fixed_bandit is None:
            S["bandit"] = rng.integers(0, 3, (1, batch)).astype(np.int32)
        S["level"] = rng.integers(0, 2, (1, batch)).astype(np.int32)
        p0 = rng.uniform(0.05, 0.95, (3, batch)).astype(np.float32)
        S["policies"] = np.stack([p0, np.float32(1.0) - p0], axis=1).reshape(
            6, batch)
        showing = rng.random(batch) < 0.25
        S["showing"] = showing.astype(np.float32).reshape(1, batch)
        goal = np.where(S["level"][0] == 0, *fused.goal_flat)
        nogoal = np.where(S["level"][0] == 0, *fused.nogoal_flat)
        box = np.where(rng.random(batch) < 0.5, goal, nogoal)
        on_box = (S["pos"][0] == goal) | (S["pos"][0] == nogoal)
        S["pos"][0] = np.where(showing, box,
                               np.where(on_box, fused.pos0, S["pos"][0]))


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


def busy_savanna_state(fused, seed: int, batch: int, device) -> dict:
    """A numpy-seeded mid-episode aintelope_savanna state on ``device``. It
    first calls ``fused.init_packed(seed, batch, "cpu",
    layout_pool=fused.layout_pool)``, which draws the layouts (the same ones
    as the JAX package's ``init_packed`` from that seed). Then, on each
    lane's current layout: the predators moved to random free interior gap
    cells, as many as before; agents on distinct free cells, agent 0 on a
    water, gold, silver or resource cell in one lane of four and next to a
    predator in another; satiations from -22 to 6 in steps of 0.2, on both
    sides of the thresholds and at the death limits; under sustainability,
    curtains with cells added and removed and availabilities 0 to 20 with
    fractions; random facings, safety distances, visits and stats; one lane
    in eight with a dead agent and one in eight with all agents dead (it
    resets on the next step); ``t`` near ``max_iterations`` in every other
    lane, the step counts of a round in progress or complete; draw counters
    anywhere in uint32, every other lane within 64 of the wrap; and, with a
    layout pool, episode counters 0..5."""
    rng = np.random.default_rng(seed)
    # A fused env that was packed before keeps its redraw mode.
    exact = None if fused.packed_batch is None else fused.exact_reset
    S = state_to_numpy(fused.init_packed(seed, batch, "cpu",
                                         layout_pool=fused.layout_pool,
                                         exact_reset=exact))
    n, K, HW, W = fused.n, fused.layout_pool, fused.HW, fused.w
    st = fused._kstatics_np
    if K > 1:
        S["ep_idx"] = rng.integers(0, 6, (1, batch)).astype(np.int32)
    res_names = [s["name"] for s in fused.res_specs] if fused.sustain else []
    cells = np.arange(HW)
    interior = ((cells // W >= 1) & (cells // W <= fused.h - 2)
                & (cells % W >= 1) & (cells % W <= W - 2))
    for b in range(batch):
        if fused.exact_reset:
            wall, sboard = S["wall"][:, b], S["sboard"][:, b]
        else:
            k = int(S["ep_idx"][0, b]) % K if K > 1 else 0
            sfx = f"_p{k}" if k else ""
            wall, sboard = st["wall" + sfx][:, b], st["sboard" + sfx][:, b]
            S["predator"][:, b] = st["predator0" + sfx][:, b]
            for nm in res_names:
                S["res_" + nm][:, b] = st["res0_" + nm + sfx][:, b]
        code = sboard % 16.0
        free = (wall < 0.5) & interior
        gap = free & (code == 0)
        for nm in res_names:
            gap &= S["res_" + nm][:, b] < 0.5
        n_pred = int((S["predator"][:, b] > 0.5).sum())
        S["predator"][:, b] = 0.0
        if n_pred:
            S["predator"][rng.choice(np.flatnonzero(gap), n_pred, replace=False), b] = 1.0
        pos = rng.choice(np.flatnonzero(free), size=n, replace=False)
        special = free & (code >= 2)
        for nm in res_names:
            special |= S["res_" + nm][:, b] > 0.5
        preds = np.flatnonzero(S["predator"][:, b] > 0.5)
        if b % 4 == 1 and special.any():
            pos[0] = rng.choice(np.flatnonzero(special))
        elif b % 4 == 2 and preds.size:
            nb = preds[0] + np.array([-1, 1, -W, W])
            nb = nb[free[nb]]
            if nb.size:
                pos[0] = rng.choice(nb)
        if len(set(pos.tolist())) < n:  # keep the agents on distinct cells
            rest = np.setdiff1d(np.flatnonzero(free), pos[:1])
            pos[1:] = rng.choice(rest, size=n - 1, replace=False)
        S["pos"][:, b] = pos
        for nm in res_names:
            cur = S["res_" + nm][:, b]
            on = np.flatnonzero(cur > 0.5)
            if on.size and rng.random() < 0.5:
                cur[rng.choice(on)] = 0.0
            off = np.flatnonzero(gap & (cur < 0.5) & (S["predator"][:, b] < 0.5))
            if off.size:
                cur[rng.choice(off, min(2, off.size), replace=False)] = 1.0
    for nm in res_names:
        av = rng.integers(0, 21, (1, batch)).astype(np.float32)
        frac = rng.uniform(0.01, 0.99, (1, batch)).astype(np.float32)
        S["avail_" + nm] = np.where(rng.random((1, batch)) < 0.5, av,
                                    np.minimum(av + frac, 20.0)).astype(np.float32)
    for k in ("act_dir", "obs_dir"):
        S[k] = rng.integers(0, 4, (n, batch)).astype(np.int32)
    for k in ("safety", "safety2"):
        S[k] = rng.integers(0, 12, (n, batch)).astype(np.int32)
    for k in ("drink_sat", "food_sat"):
        S[k] = (rng.integers(-110, 31, (n, batch)) * np.float32(0.2)).astype(
            np.float32)
    S["drink_sat"][:, ::16] = np.float32(-20.0)
    S["visits"] = rng.integers(0, 5, S["visits"].shape).astype(np.int32)
    S["stats_rewards"] = rng.integers(
        -300, 300, S["stats_rewards"].shape).astype(np.float32)
    S["stats_episodes"] = rng.integers(0, 30, (1, batch)).astype(np.int32)
    T = fused.max_iterations
    t = rng.integers(0, T, batch)
    t[::2] = rng.integers(max(0, T - 4), T, (batch + 1) // 2)
    S["t"][0] = t
    # Step counts: a complete round (all equal) or one in progress.
    count = np.repeat((t // n)[None], n, axis=0)
    partial = rng.random(batch) < 0.5
    count[0, partial] += 1
    S["step_count"] = count.astype(np.int32)
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


def fused_ppo_state_from_numpy(fused, params: dict, mu: dict, nu: dict,
                               count, S: dict, config, device,
                               update_idx: int = 0):
    """The JAX package's ``FusedPPOState`` as the port's: ``params`` and
    optax's Adam moments ``mu`` and ``nu`` (dicts of numpy arrays by MLP
    key), its ``count`` and the packed state ``S`` (numpy), on ``device``.
    ``fused`` must hold the statics ``S`` was packed with (``init_packed``
    of the same seed and batch). Adam's state is what ``torch.optim.Adam``
    would hold after ``count`` steps; the JAX state's key is unused by its
    train step and has no counterpart."""
    from ai_safety_gridworlds_torch.learners import ppo_fused

    if set(S) != set(fused.STATE_FIELDS):
        raise ValueError(
            f"state fields {sorted(S)} are not the engine's "
            f"{sorted(fused.STATE_FIELDS)}"
        )
    p = {k: v.requires_grad_() for k, v in
         params_from_numpy(params, device).items()}
    opt = ppo_fused._optimizer(p, config)
    for k in MLP_KEYS:
        # torch.optim.Adam's state as its count-th step leaves it (the
        # count on the host, in float32).
        opt.state[p[k]] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[k], np.float32)).to(
                device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[k], np.float32)).to(
                device),
        }
    return ppo_fused.FusedPPOState(
        params=p, opt=opt,
        S=state_from_numpy({k: S[k] for k in fused.STATE_FIELDS}, device),
        update_idx=int(update_idx),
    )


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


def env_state_from_numpy(state_cls, arrays, device):
    """A JAX env state as the port's dataclass ``state_cls`` on ``device``.

    ``arrays`` maps each field of ``state_cls`` to a numpy array with a
    leading lane dim (``jax.vmap``'s layout), as a dict or as an object
    with the fields as attributes (the JAX state after ``np.asarray`` of
    its leaves). Every field must be there and no other; ``key`` must be
    uint32 ``[B, 2]`` (it becomes int64), every other leaf bool, uint8,
    int32 or float32 (kept)."""
    names = [f.name for f in dataclasses.fields(state_cls)]
    if not isinstance(arrays, dict):
        arrays = {n: getattr(arrays, n) for n in names if hasattr(arrays, n)}
    if set(arrays) != set(names):
        raise ValueError(
            f"{state_cls.__name__}: fields {sorted(arrays)} are not "
            f"{sorted(names)}")
    out, batch = {}, None
    for name in names:
        a = np.asarray(arrays[name])
        if name == "key":
            if a.dtype != np.uint32 or a.ndim != 2 or a.shape[1] != 2:
                raise TypeError(
                    f"key: uint32 [B, 2] expected, got {a.dtype}{a.shape}")
            t = torch.from_numpy(a.astype(np.int64))
        elif a.dtype in _ENV_DTYPES:
            t = torch.from_numpy(np.array(a, order="C"))
        else:
            raise TypeError(f"{name}: dtype {a.dtype} is not a JAX state's")
        if a.ndim == 0 or (batch is not None and a.shape[0] != batch):
            raise ValueError(f"{name}: no leading lane dim of {batch}")
        batch = a.shape[0]
        out[name] = t.to(device)
    return state_cls(**out)


def env_state_to_numpy(state) -> dict:
    """A port env state as numpy arrays by field with JAX's dtypes (the
    key as uint32), on the host: the inverse of
    :func:`env_state_from_numpy`."""
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name).detach().cpu().numpy()
        out[f.name] = a.astype(np.uint32) if f.name == "key" else a
    return out
