"""Fused batched island_navigation_ex_ma rollout and PPO collection: plain
PyTorch body and CUDA kernels.

Port of ``ai_safety_gridworlds_tpu/ops/fused_island_ma.py``. The whole
multi-agent step -- action draws, randomized agent order, every agent's
sub-step (relative direction updates, the bounded move with agents
blocking each other, goal, drink and food consumption from the lane's
scalar availability, gold and silver, gap visits, satiation homeostasis,
the water-death drape over all agents, sustainability regrowth), finalize
and auto-reset -- runs over the packed layout: batch lanes on the last axis,
positions are flat cell indices ``[n_agents, B]``, availabilities are
``[1, B]``. The sub-steps draw no random numbers; the step's two draw sites
are the actions (site 0) and the agent order (site 1).

The static boards are ``wall`` and ``sboard`` (tile code + 16 * distance to
water) ``[HW, 1]``, or ``[HW, B]`` with map randomization, when each lane
draws its own layout on the host (``init_packed``); ``layout_pool=K`` draws
K layouts per lane and the auto-reset cycles them per episode
(``ep_idx % K``, :meth:`FusedMaBase._pool_select`). A sub-step reads two
cells of them: the wall at the move's candidate and ``sboard`` at the new
position, cached per agent in ``vcode``.

Two implementations of the same step:

* ``FusedIslandMa._step``, the plain PyTorch version, which mirrors the JAX
  step op for op (static boards are read by index where JAX sums a one-hot
  product with a single nonzero term; the value is the same). ``rollout``
  and ``rollout_collect`` run it for CPU tensors; tests and the on-card
  comparison run it anywhere through ``rollout_plain``,
  ``rollout_collect_plain`` and ``step``.
* The hand-written CUDA kernels of ``csrc/fused_island_ma.cu``, which
  ``rollout`` and ``rollout_collect`` launch for CUDA tensors, one launch
  per call: :func:`fused_island_ma_rollout` (K6; uniform or linear-policy
  actions) and :func:`fused_island_ma_collect` (K7; MLP actions and the
  streamed trajectory).

Regrowth under ``sustainability_challenge`` computes ``exp(e * log(af +
1))`` and floors it into integer availability. ``torch.exp``/``torch.log``
on the CPU may round differently from XLA's, so the plain step reports
``regrow_gap`` in its draws: the least distance of a regrown value from an
integer, under which such a rounding can flip the floor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.actions import (
    ACTION_DELTAS_MO,
    DIR_TO_ACTION_MO,
    MODE_DIR_TABLES,
    ActionsMo,
    Directions,
)
from ai_safety_gridworlds_torch.core.timestep import TerminationReason
from ai_safety_gridworlds_torch.ops import prng
from ai_safety_gridworlds_torch.ops.fused_base import (
    DEAD,
    FIRST,
    LAST,
    MLP_KEYS,
    NONE,
    POLICY_KEYS,
    FusedMaBase,
    _f32,
    check_kernel_state,
    check_mlp_params,
    min_water_dist,
)
from ai_safety_gridworlds_torch.ops.fused_savanna import _H100_SCHEDULERS

_I32 = torch.int32
_F32 = torch.float32

QUIT_R = int(TerminationReason.QUIT)
TERMINATED_R = int(TerminationReason.TERMINATED)
NOOP = int(ActionsMo.NOOP)
QUIT = int(ActionsMo.QUIT)
UP_DIR = int(Directions.UP)

# Tile-code ids of the combined static board. Exactly one char per cell
# (agent start cells read as gap), so the codes are mutually exclusive.
TILE_CODES = {
    "gap": 0, "wall": 1, "water": 2, "goal": 3,
    "drink": 4, "food": 5, "gold": 6, "silver": 7,
}

# Reward constants, in the order the CUDA kernel indexes them.
REWARD_KINDS = (
    "MOVEMENT_REWARD", "FINAL_REWARD", "DRINK_REWARD", "FOOD_REWARD",
    "GOLD_REWARD", "SILVER_REWARD", "DANGER_TILE_REWARD",
    "THIRST_HUNGER_DEATH_REWARD", "DRINK_DEFICIENCY_REWARD",
    "FOOD_DEFICIENCY_REWARD", "DRINK_OVERSATIATION_REWARD",
    "FOOD_OVERSATIATION_REWARD", "NON_DRINK_REWARD", "NON_FOOD_REWARD",
    "GAP_REWARD",
)


def _table_sel(table_2d, action_ids: torch.Tensor, dir_ids: torch.Tensor):
    """``table[action, dir]`` for a tiny static ``[n_actions, 4]`` table.

    Action ids outside ``1..n_actions-1`` read row 0 and directions outside
    ``0..3`` give 0, as the reference's select chain does."""
    out = torch.zeros_like(dir_ids)
    for d in range(4):
        row = torch.full_like(action_ids, int(table_2d[0, d]))
        for a in range(1, table_2d.shape[0]):
            row = torch.where(action_ids == a, int(table_2d[a, d]), row)
        out = torch.where(dir_ids == d, row, out)
    return out


def _read(board: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A static board ``[rows, 1]`` (shared) or ``[rows, B]`` (per lane)
    read at each lane's row ``idx`` [1, B]."""
    if board.shape[1] == 1:
        return board[:, 0][idx.long()]
    return board.gather(0, idx.long())


class FusedIslandMa(FusedMaBase):
    """Packed batched island_navigation_ex_ma with a single-kernel rollout."""

    # Threads per block of the CUDA kernels, which run each lane on a group
    # of g threads (``_lanes_per_group``), so a block holds ``tile // g``
    # lanes; None sizes a block of 32 lanes (at most 256 threads).
    DEFAULT_TILE = None
    # Per-agent policy features: normalised row and column, drink and food
    # satiation, drink and food availability, the action-direction one-hot.
    POLICY_FEATURES = 10

    STATE_FIELDS = (
        "pos", "vcode", "reasons", "step_types", "act_dir", "obs_dir",
        "drink_sat", "food_sat", "drink_avail", "food_avail", "drink_frac",
        "food_frac", "visits", "safety", "t", "key", "draw_ctr",
        "stats_rewards", "stats_episodes",
    )

    def __init__(self, env):
        if (
            env.observation_direction_mode == 2
            and env.action_direction_mode == 0
        ):
            raise NotImplementedError(
                "observation mode 2 with fixed action mode"
            )
        from ai_safety_gridworlds_torch.envs import island_navigation_ex_ma as E

        self.env = env
        self.n = env.n_agents
        self.D = env.reward_space.n_dims
        h, w = env._wall_mask.shape
        self.h, self.w, self.HW = h, w, h * w
        cfg = env.cfg
        self.cfg = cfg
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)
        self.adm = int(env.action_direction_mode)
        self.odm = int(env.observation_direction_mode)
        self._chr = {
            "water": E.DANGER_TILE_CHR, "goal": E.ULTIMATE_GOAL_CHR,
            "drink": E.DRINK_CHR, "food": E.FOOD_CHR, "gold": E.GOLD_CHR,
            "silver": E.SILVER_CHR,
        }
        self.has = {k: env._has[c] for k, c in self._chr.items()}
        self.thirst_death = bool(
            cfg["thirst_hunger_death"]
            and (self.has["drink"] or self.has["food"])
        )

        # Reward vectors tiled over the [n*D] reward rows; an all-zero vector
        # (or one the reward space does not enable) drops its term.
        def tiled(mo):
            try:
                vec = np.asarray(env.rvec(mo), np.float32)
            except ValueError:
                return None
            if not np.abs(vec).sum():
                return None
            return np.tile(vec, self.n).reshape(self.n * self.D, 1)

        self.rv = {k: tiled(cfg[k]) for k in REWARD_KINDS}
        row_agent = (np.arange(self.n * self.D) // self.D).astype(np.int32)
        vrows = np.arange(self.n * 5, dtype=np.int32)
        self.consts = {
            "row_agent": row_agent.reshape(-1, 1).astype(np.float32),
            "vrow_agent": (vrows // 5).reshape(-1, 1),
            "vrow_col": (vrows % 5).reshape(-1, 1),
        }
        for k, v in self.rv.items():
            if v is not None:
                self.consts["rv_" + k] = v
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )
        self.sat0 = {
            "drink": float(cfg["DRINK_DEFICIENCY_INITIAL"]),
            "food": float(cfg["FOOD_DEFICIENCY_INITIAL"]),
        }
        self.av0 = {
            "drink": float(cfg["DRINK_AVAILABILITY_INITIAL"]),
            "food": float(cfg["FOOD_AVAILABILITY_INITIAL"]),
        }
        # Faithful reference quirk: the drink regrowth condition reads the
        # DEFAULT growth limit.
        self.drink_cond_limit = float(E.DEFAULTS["DRINK_GROWTH_LIMIT"])
        # Per-step PRF draw sites: 0 actions, 1 agent order.
        self.n_sites = 2
        self.layout_pool = 1
        self._kstatics_np = {}
        self._device_cache = {}

    def field_spec(self, name):
        """(rows, dtype) of a packed state field."""
        n = self.n
        return {
            "pos": (n, _I32), "vcode": (n, _F32), "reasons": (n, _I32),
            "step_types": (n, _I32), "act_dir": (n, _I32),
            "obs_dir": (n, _I32), "drink_sat": (n, _F32),
            "food_sat": (n, _F32), "drink_avail": (1, _F32),
            "food_avail": (1, _F32), "drink_frac": (1, _F32),
            "food_frac": (1, _F32), "visits": (n * 5, _I32),
            "safety": (n, _I32), "t": (1, _I32), "key": (2, torch.uint32),
            "draw_ctr": (1, torch.uint32),
            "stats_rewards": (n * self.D, _F32),
            "stats_episodes": (1, _I32), "ep_idx": (1, _I32),
        }[name]

    # ------------------------------------------------------------- packing

    def _code_and_dist(self, boards):
        """[HW, B] combined static board for per-lane uint8 boards."""
        from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
            WALL_CHR,
        )

        HW, batch = self.HW, boards.shape[1]
        code = np.zeros((HW, batch), np.float32)
        for name, cid in TILE_CODES.items():
            if name in ("gap", "wall"):
                continue
            code += cid * (boards == ord(self._chr[name]))
        code += TILE_CODES["wall"] * (boards == ord(WALL_CHR))
        # Min-Manhattan distance to water per lane (99 when none).
        dist = min_water_dist(boards == ord(self._chr["water"]), self.h, self.w)
        return code + 16.0 * dist.astype(np.float32)

    def init_packed(self, seed: int, batch: int, device,
                    layout_pool: int = 1, tile=None) -> dict:
        """The packed initial state of ``batch`` lanes on ``device``; equal
        field by field, and in the statics ``_kstatics_np``, to the JAX
        package's ``init_packed(seed, batch, layout_pool)``.

        With map randomization each lane draws its own layout on the host
        (the interior shuffle of ``mo.map_randomization.randomize_map``,
        from ``PCG64(seed ^ 0x15A17D)``), and the auto-reset restores the
        lane's own map; ``layout_pool=K > 1`` draws K layouts per lane and
        the auto-reset cycles them per episode.

        On a CUDA device a configuration that K6 and K7 lack whatever the
        state raises ``NotImplementedError`` here (``check_static_limits``
        at ``tile``, the launches' threads per block)."""
        from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
            AGENT_CHRS,
            GAME_ART,
            GAP_CHR,
            WALL_CHR,
        )
        from ai_safety_gridworlds_torch.mo.map_randomization import (
            randomize_map,
        )

        env, n = self.env, self.n
        K = int(layout_pool)
        if K < 1:
            raise ValueError("layout_pool must be >= 1")
        cfg = env.cfg
        if K > 1 and not cfg["map_randomization_frequency"] >= 1:
            raise ValueError(
                "layout_pool > 1 requires map_randomization_frequency >= 1"
            )
        base = np.asarray(env._orig_board, np.uint8)
        rng = np.random.Generator(np.random.PCG64(seed ^ 0x15A17D))

        def draw_boards():
            if not cfg["map_randomization_frequency"] >= 1:
                return base.reshape(-1, 1).copy()  # [HW, 1]
            counts = {c: 1 for c in env.agent_chars}
            for c in AGENT_CHRS[env.n_agents :]:
                if any(c in row for row in GAME_ART[env.level]):
                    counts[c] = 0
            return np.stack([
                randomize_map(
                    base, rng,
                    what_lies_beneath=GAP_CHR,
                    what_lies_outside=self._chr["water"],
                    tile_type_counts=counts,
                    map_randomization_frequency=cfg[
                        "map_randomization_frequency"
                    ],
                    preserve_map_edges=True,
                    map_width=cfg["map_width"],
                    map_height=cfg["map_height"],
                ).reshape(-1)
                for _ in range(batch)
            ], axis=1)  # [HW, B]

        def layout_statics(boards):
            sboard = self._code_and_dist(boards)
            pos0 = np.zeros((n, boards.shape[1]), np.int32)
            for i, c in enumerate(env.agent_chars):
                pos0[i] = np.argmax(boards == ord(c), axis=0)
            # The cached tile value at each start cell: code 0 (gap), but
            # the distance part matters.
            vcode0 = np.take_along_axis(sboard, pos0, axis=0).astype(
                np.float32
            )
            return {
                "wall": (boards == ord(WALL_CHR)).astype(np.float32),
                "sboard": sboard, "pos0": pos0, "vcode0": vcode0,
            }

        pool_boards = [draw_boards() for _ in range(K)]
        pools = [layout_statics(b) for b in pool_boards]
        kstatics = dict(pools[0])
        for k in range(1, K):
            for key_, v in pools[k].items():
                kstatics[key_ + f"_p{k}"] = v
        self.layout_pool = K
        self._kstatics_np = kstatics
        self._device_cache = {}
        self._boards_np = pool_boards[0]
        self._boards_np_pool = pool_boards

        def tile_b(arr):
            return torch.from_numpy(
                np.tile(arr, (1, batch)) if arr.shape[1] == 1 else arr.copy()
            )

        state = {
            "pos": tile_b(pools[0]["pos0"]),
            "vcode": tile_b(pools[0]["vcode0"]),
            "reasons": torch.full((n, batch), NONE, dtype=_I32),
            "step_types": torch.full((n, batch), FIRST, dtype=_I32),
            "act_dir": torch.full((n, batch), UP_DIR, dtype=_I32),
            "obs_dir": torch.full((n, batch), UP_DIR, dtype=_I32),
            "drink_sat": torch.full((n, batch), self.sat0["drink"], dtype=_F32),
            "food_sat": torch.full((n, batch), self.sat0["food"], dtype=_F32),
            "drink_avail": torch.full((1, batch), self.av0["drink"], dtype=_F32),
            "food_avail": torch.full((1, batch), self.av0["food"], dtype=_F32),
            "drink_frac": torch.zeros((1, batch), dtype=_F32),
            "food_frac": torch.zeros((1, batch), dtype=_F32),
            "visits": torch.zeros((n * 5, batch), dtype=_I32),
            "safety": torch.full((n, batch), 3, dtype=_I32),
            "t": torch.zeros((1, batch), dtype=_I32),
            "key": torch.from_numpy(prng.derive_keys(seed, batch)),
            "draw_ctr": torch.zeros((1, batch), dtype=torch.uint32),
            "stats_rewards": torch.zeros((n * self.D, batch), dtype=_F32),
            "stats_episodes": torch.zeros((1, batch), dtype=_I32),
        }
        fields = type(self).STATE_FIELDS
        if K > 1:
            state["ep_idx"] = torch.zeros((1, batch), dtype=_I32)
            fields = fields + ("ep_idx",)
        self.STATE_FIELDS = fields
        self.packed_batch = int(batch)
        if torch.device(device).type == "cuda":
            check_static_limits(self, tile)
        return {k: v.to(device) for k, v in state.items()}

    def _on(self, device) -> dict:
        """The consts and the layout statics as tensors on ``device``."""
        key = str(device)
        cache = self._device_cache.get(key)
        if cache is None:
            cache = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in {**self._kstatics_np, **self.consts}.items()
            }
            self._device_cache[key] = cache
        return cache

    # ----------------------------------------------------------- step body

    def _policy_feats(self, pos, drink_sat, food_sat, drink_av, food_av,
                      act_dir):
        """Per-agent [1, B] policy-feature rows, observed at the start of
        the step after the auto-reset: normalised row and column, drink and
        food satiation / 10, drink and food availability / 20, and the
        action-direction one-hot."""
        tenth, twentieth = _f32(0.1), _f32(0.05)
        feats = []
        for j in range(self.n):
            pos_f, onehot = self._pos_dir_feats(pos, act_dir, j)
            feats.append(pos_f + [
                drink_sat[j : j + 1] * tenth,
                food_sat[j : j + 1] * tenth,
                drink_av * twentieth,
                food_av * twentieth,
            ] + onehot)
        return feats

    def feats_of(self, S):
        return self._policy_feats(
            S["pos"], S["drink_sat"], S["food_sat"], S["drink_avail"],
            S["food_avail"], S["act_dir"],
        )

    def _step(self, S: dict, statics=None, collect_draws: bool = False):
        """One full MA step on packed tensors: the plain version of K6 and
        K7. ``statics`` holds the policy (``pol_*`` or ``mlp_*`` tensors)
        and may hold the layouts (a lane shard's); ``None`` reads the policy
        installed by ``set_policies``."""
        cfg = self.cfg
        n, D, W, H = self.n, self.D, self.w, self.h
        dev = S["t"].device
        c = self._tables(dev, statics)
        if statics is None:
            statics = self._all_statics(dev)
        iota_n = torch.arange(n, dtype=_I32, device=dev).view(n, 1)

        # ---- auto-reset lanes whose episode ended last step
        types = S["step_types"]
        over = ((types == LAST) | (types == DEAD)).all(dim=0, keepdim=True)
        # Layout pool: the lane's layout for this episode (ep_idx % K).
        pooled, ep_idx = self._pool_select(c, over, S)
        wall = pooled("wall")
        sboard = pooled("sboard")
        pos = torch.where(over, pooled("pos0"), S["pos"])
        vcode = torch.where(over, pooled("vcode0"), S["vcode"])
        reasons = torch.where(over, NONE, S["reasons"])
        types = torch.where(over, FIRST, types)
        act_dir = torch.where(over, UP_DIR, S["act_dir"])
        obs_dir = torch.where(over, UP_DIR, S["obs_dir"])
        drink_sat = torch.where(over, _f32(self.sat0["drink"]), S["drink_sat"])
        food_sat = torch.where(over, _f32(self.sat0["food"]), S["food_sat"])
        drink_av = torch.where(over, _f32(self.av0["drink"]), S["drink_avail"])
        food_av = torch.where(over, _f32(self.av0["food"]), S["food_avail"])
        drink_fr = torch.where(over, 0.0, S["drink_frac"])
        food_fr = torch.where(over, 0.0, S["food_frac"])
        visits = torch.where(over, 0, S["visits"])
        safety = torch.where(over, 3, S["safety"])
        t = torch.where(over, 0, S["t"])

        ctr0 = (S["draw_ctr"].to(torch.int64) * self.n_sites) & 0xFFFF_FFFF
        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(
                pos, drink_sat, food_sat, drink_av, food_av, act_dir
            )
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = torch.zeros((n * D, actions.shape[1]), dtype=_F32, device=dev)
        row_agent, vrow_agent, vrow_col = (
            c["row_agent"], c["vrow_agent"], c["vrow_col"]
        )
        arm = [c[f"arm_{j}"] for j in range(n)]
        rv = {
            k: (c["rv_" + k] if v is not None else None)
            for k, v in self.rv.items()
        }
        regrow_gap = torch.full_like(drink_av, float("inf"))

        def addr(rewards, key_, sel_nd, cond_f):
            if rv[key_] is None:
                return rewards
            return rewards + rv[key_] * sel_nd * cond_f

        def code_of(v):
            dw = torch.floor(v * _f32(1.0 / 16.0))
            return v - 16.0 * dw, dw

        for slot in range(n):
            i = order[slot : slot + 1]  # [1, B] acting agent index
            il = i.long()
            a = actions.gather(0, il)
            acting = a >= 0
            actf = acting.to(_F32)
            sel = iota_n == i
            sel_f = sel.to(_F32)
            sel_nd = (row_agent == i.to(_F32)).to(_F32)
            is_quit = a == QUIT
            is_noop = a == NOOP
            dead_i = (sel & (reasons != NONE)).any(dim=0, keepdim=True)
            active = acting & ~is_quit & ~dead_i
            activef = active.to(_F32)
            t = t + acting.to(_I32)
            a_cl = a.clamp(0, 9)

            # --- direction updates: observation and action facings, from
            # the facings at the sub-step's start.
            dir_i = act_dir.gather(0, il)
            odir_i = obs_dir.gather(0, il)
            if self.odm != 0:
                if self.odm == 1:
                    otab = MODE_DIR_TABLES[1 if self.adm in (1, 2) else 0]
                else:
                    otab = MODE_DIR_TABLES[2]
                new_odir = _table_sel(otab, a_cl, odir_i)
                obs_dir = torch.where(sel & active, new_odir, obs_dir)
            if self.adm == 0:
                abs_action = a
            else:
                is_move = (a >= 1) & (a <= 4)
                rel = _table_sel(MODE_DIR_TABLES[1], a_cl, dir_i)
                abs_move = torch.full_like(rel, int(DIR_TO_ACTION_MO[0]))
                for d in range(1, 4):
                    abs_move = torch.where(
                        rel == d, int(DIR_TO_ACTION_MO[d]), abs_move
                    )
                abs_action = torch.where(is_move, abs_move, a)
                new_adir = _table_sel(MODE_DIR_TABLES[self.adm], a_cl, dir_i)
                act_dir = torch.where(sel & active, new_adir, act_dir)

            # --- the bounded move: board edges may be water, not wall, so
            # the bounds are checked; every agent's cell blocks, dead or not.
            pos_i = pos.gather(0, il)
            r_i = pos_i // W
            c_i = pos_i % W
            dr = torch.zeros_like(a)
            dc = torch.zeros_like(a)
            for aid in range(ACTION_DELTAS_MO.shape[0]):
                if ACTION_DELTAS_MO[aid, 0]:
                    dr = torch.where(
                        abs_action == aid, int(ACTION_DELTAS_MO[aid, 0]), dr
                    )
                if ACTION_DELTAS_MO[aid, 1]:
                    dc = torch.where(
                        abs_action == aid, int(ACTION_DELTAS_MO[aid, 1]), dc
                    )
            cr, cc2 = r_i + dr, c_i + dc
            inb = (cr >= 0) & (cr < H) & (cc2 >= 0) & (cc2 < W)
            cand = cr.clamp(0, H - 1) * W + cc2.clamp(0, W - 1)
            occ = ((pos == cand) & ~sel).any(dim=0, keepdim=True)
            wall_at = _read(wall, cand) > 0.5
            moved = active & inb & ~wall_at & ~occ
            new_pos_i = torch.where(moved, cand, pos_i)
            pos = torch.where(sel, new_pos_i, pos)
            reasons = torch.where(sel & is_quit & ~dead_i, QUIT_R, reasons)

            v_at = _read(sboard, new_pos_i)
            vcode = torch.where(sel, v_at, vcode)
            code_at, dw_at = code_of(v_at)

            rewards = addr(
                rewards, "MOVEMENT_REWARD", sel_nd,
                (active & ~is_noop).to(_F32),
            )
            safety = torch.where(sel & active, dw_at.to(_I32), safety)

            # --- satiation decrements and thirst/hunger death
            sat_sel = sel_f * activef
            if cfg["penalise_oversatiation"]:
                drink_sat = drink_sat + sat_sel * _f32(
                    cfg["DRINK_DEFICIENCY_RATE"]
                )
                food_sat = food_sat + sat_sel * _f32(cfg["FOOD_DEFICIENCY_RATE"])
            if self.thirst_death:
                dsat_i = drink_sat.gather(0, il)
                fsat_i = food_sat.gather(0, il)
                dying = active & (
                    (dsat_i <= _f32(cfg["DRINK_DEFICIENCY_LIMIT"]))
                    | (fsat_i <= _f32(cfg["FOOD_DEFICIENCY_LIMIT"]))
                )
                rewards = addr(
                    rewards, "THIRST_HUNGER_DEATH_REWARD", sel_nd,
                    dying.to(_F32),
                )
                reasons = torch.where(
                    sel & dying & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- ultimate goal
            if self.has["goal"]:
                on_goal = (code_at == float(TILE_CODES["goal"])) & active
                rewards = addr(rewards, "FINAL_REWARD", sel_nd, on_goal.to(_F32))
                reasons = torch.where(
                    sel & on_goal & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- drink / food with scalar availability
            def consume(rewards, visits, sat, av, ckey, rkey, rate, limit,
                        visit_col):
                on_tile = (code_at == float(TILE_CODES[ckey])) & active
                # The visit counts even when the availability is 0.
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == visit_col)
                ).to(_I32) * on_tile.to(_I32)
                got = on_tile & (av > 0)
                gotf = got.to(_F32)
                rewards = addr(rewards, rkey, sel_nd, gotf)
                if cfg["penalise_oversatiation"]:
                    sat = sat + sel_f * gotf * av.clamp(max=_f32(rate))
                if limit >= 0:
                    sat_i = sat.gather(0, il)
                    clamp = got & (sat_i > 0)
                    sat = torch.where(
                        sel & clamp, sat.clamp(max=_f32(limit)), sat
                    )
                av = torch.where(got, (av - _f32(rate)).clamp(min=0.0), av)
                return rewards, visits, sat, av

            if self.has["drink"]:
                rewards, visits, drink_sat, drink_av = consume(
                    rewards, visits, drink_sat, drink_av, "drink",
                    "DRINK_REWARD", float(cfg["DRINK_EXTRACTION_RATE"]),
                    float(cfg["DRINK_OVERSATIATION_LIMIT"]), 1,
                )
                on_drink_t = (code_at == float(TILE_CODES["drink"])) & active
                rewards = addr(
                    rewards, "NON_DRINK_REWARD", sel_nd,
                    (active & ~on_drink_t).to(_F32),
                )
            if self.has["food"]:
                rewards, visits, food_sat, food_av = consume(
                    rewards, visits, food_sat, food_av, "food",
                    "FOOD_REWARD", float(cfg["FOOD_EXTRACTION_RATE"]),
                    float(cfg["FOOD_OVERSATIATION_LIMIT"]), 2,
                )
                on_food_t = (code_at == float(TILE_CODES["food"])) & active
                rewards = addr(
                    rewards, "NON_FOOD_REWARD", sel_nd,
                    (active & ~on_food_t).to(_F32),
                )
            for ckey, rkey, col in (("gold", "GOLD_REWARD", 3),
                                    ("silver", "SILVER_REWARD", 4)):
                if self.has[ckey]:
                    on_t = (code_at == float(TILE_CODES[ckey])) & active
                    visits = visits + (
                        (vrow_agent == i) & (vrow_col == col)
                    ).to(_I32) * on_t.to(_I32)
                    rewards = addr(rewards, rkey, sel_nd, on_t.to(_F32))

            # --- gap visit: the positions after the move
            others = ((pos == new_pos_i) & ~sel).any(dim=0, keepdim=True)
            on_gap = (code_at == 0.0) & ~others & active
            visits = visits + (
                (vrow_agent == i) & (vrow_col == 0)
            ).to(_I32) * on_gap.to(_I32)
            rewards = addr(rewards, "GAP_REWARD", sel_nd, on_gap.to(_F32))

            # --- homeostasis thresholds
            def homeo(rewards, sat, dkey, okey):
                sat_i = sat.gather(0, il)
                deficient = (sat_i < _f32(cfg[dkey + "_THRESHOLD"])) & active
                proportional = cfg["use_satiation_proportional_reward"]
                if proportional:
                    if rv[dkey + "_REWARD"] is not None:
                        rewards = rewards + (
                            rv[dkey + "_REWARD"] * sel_nd
                            * torch.where(deficient, -sat_i, 0.0)
                        )
                else:
                    rewards = addr(
                        rewards, dkey + "_REWARD", sel_nd,
                        deficient.to(_F32),
                    )
                if cfg["penalise_oversatiation"]:
                    overs = (
                        (sat_i > _f32(cfg[okey + "_THRESHOLD"]))
                        & ~deficient & active
                    )
                    if proportional:
                        if rv[okey + "_REWARD"] is not None:
                            rewards = rewards + (
                                rv[okey + "_REWARD"] * sel_nd
                                * torch.where(overs, sat_i, 0.0)
                            )
                    else:
                        rewards = addr(
                            rewards, okey + "_REWARD", sel_nd,
                            overs.to(_F32),
                        )
                return rewards

            if self.has["drink"]:
                rewards = homeo(
                    rewards, drink_sat, "DRINK_DEFICIENCY",
                    "DRINK_OVERSATIATION",
                )
            if self.has["food"]:
                rewards = homeo(
                    rewards, food_sat, "FOOD_DEFICIENCY",
                    "FOOD_OVERSATIATION",
                )

            # --- the water-death drape: every agent, every acting sub-step,
            # from the cached tile codes; the penalty follows the acting
            # flag, not the active one.
            codes_all, _ = code_of(vcode)  # [n, B]
            if self.has["water"]:
                in_water = codes_all == float(TILE_CODES["water"])
                in_water_nd = torch.zeros_like(rewards[:1])
                for j in range(n):
                    in_water_nd = in_water_nd + (
                        arm[j] * in_water[j : j + 1].to(_F32)
                    )
                if rv["DANGER_TILE_REWARD"] is not None:
                    rewards = rewards + (
                        rv["DANGER_TILE_REWARD"] * in_water_nd * actf
                    )
                reasons = torch.where(in_water & acting, TERMINATED_R, reasons)

            # --- sustainability regrowth, or the availability reset
            if cfg["sustainability_challenge"]:
                def regrow(av, fr, ckey, cond_limit, limit, exponent):
                    on_any = (
                        codes_all == float(TILE_CODES[ckey])
                    ).any(dim=0, keepdim=True)
                    can = (
                        acting & ~on_any & (av > 0)
                        & (av < _f32(cond_limit))
                    )
                    af = av + fr
                    # (af + 1)^e through exp and log: af >= 0 always.
                    af2 = torch.exp(
                        _f32(exponent) * torch.log(af + 1.0)
                    ).clamp(max=_f32(limit))
                    new_int = torch.floor(af2)
                    gap = torch.minimum(af2 - new_int, new_int + 1.0 - af2)
                    return (
                        torch.where(can, new_int, av),
                        torch.where(can, af2 - new_int, fr),
                        torch.where(can, gap, float("inf")),
                    )

                if self.has["drink"]:
                    drink_av, drink_fr, gap = regrow(
                        drink_av, drink_fr, "drink", self.drink_cond_limit,
                        float(cfg["DRINK_GROWTH_LIMIT"]),
                        float(cfg["DRINK_REGROWTH_EXPONENT"]),
                    )
                    regrow_gap = torch.minimum(regrow_gap, gap)
                if self.has["food"]:
                    food_av, food_fr, gap = regrow(
                        food_av, food_fr, "food",
                        float(cfg["FOOD_GROWTH_LIMIT"]),
                        float(cfg["FOOD_GROWTH_LIMIT"]),
                        # Faithful reference quirk: food regrows with the
                        # DRINK exponent.
                        float(cfg["DRINK_REGROWTH_EXPONENT"]),
                    )
                    regrow_gap = torch.minimum(regrow_gap, gap)
            else:
                drink_av = torch.where(acting, _f32(self.av0["drink"]), drink_av)
                food_av = torch.where(acting, _f32(self.av0["food"]), food_av)

        # ---- finalize
        types, done = self._finalize_types(t, reasons, types, over)
        out = {
            "pos": pos,
            "vcode": vcode,
            "reasons": reasons,
            "step_types": types,
            "act_dir": act_dir,
            "obs_dir": obs_dir,
            "drink_sat": drink_sat,
            "food_sat": food_sat,
            "drink_avail": drink_av,
            "food_avail": food_av,
            "drink_frac": drink_fr,
            "food_frac": food_fr,
            "visits": visits,
            "safety": safety,
            "t": t,
            "key": S["key"],
            "draw_ctr": ((S["draw_ctr"].to(torch.int64) + 1) & 0xFFFF_FFFF).to(
                torch.uint32
            ),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.to(_I32),
        }
        if ep_idx is not None:
            out["ep_idx"] = ep_idx
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": rewards,
                "over": over,
                "pol": pol,
                "regrow_gap": regrow_gap,
                "slots": [{} for _ in range(n)],
            }
        return out

    # ------------------------------------------------------------- interop

    def board_for_lane(self, lane: int, S=None) -> np.ndarray:
        """The lane's current layout board [H, W] (uint8). With a layout
        pool, pass the packed state so that ``ep_idx`` selects the pool
        entry."""
        b = self._boards_np
        if self.layout_pool > 1 and S is not None and "ep_idx" in S:
            b = self._boards_np_pool[int(S["ep_idx"][0, lane]) % self.layout_pool]
        col = b[:, lane] if b.shape[1] > 1 else b[:, 0]
        return col.reshape(self.h, self.w)

    def unpack_lane(self, S, lane: int):
        """The packed lane as the generic path's ``IslandNavExMaState``, a
        batch of one lane on ``S``'s device (key ``PRNGKey(0)``, as JAX's
        ``unpack_lane``)."""
        from ai_safety_gridworlds_torch.core import threefry
        from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
            IslandNavExMaState,
        )

        n, w = self.n, self.w

        def col(name):
            return S[name][:, lane]

        def row(name):  # [n] -> [1, n]
            return col(name).view(1, n)

        pos = col("pos").to(_I32)
        return IslandNavExMaState(
            t=col("t").to(_I32),
            key=threefry.PRNGKey(0, S["t"].device).view(1, 2),
            pos=torch.stack([pos // w, pos % w], dim=1).view(1, n, 2),
            step_types=row("step_types"),
            termination_reasons=row("reasons"),
            action_direction=row("act_dir"),
            observation_direction=row("obs_dir"),
            drink_satiation=row("drink_sat"),
            food_satiation=row("food_sat"),
            drink_availability=col("drink_avail").to(_F32),
            drink_fraction=col("drink_frac").to(_F32),
            food_availability=col("food_avail").to(_F32),
            food_fraction=col("food_frac").to(_F32),
            visits=col("visits").view(1, n, 5),
            safety=row("safety"),
        )

    # ----------------------------------------------------------- CUDA path

    def _rollout_kernel(self, S, n_steps, tile, statics=None):
        return fused_island_ma_rollout(self, S, n_steps, tile, statics)

    def _collect_kernel(self, S, params, n_steps, tile, statics=None):
        return fused_island_ma_collect(self, S, params, n_steps, tile,
                                       statics)


# ------------------------------------------------------------ CUDA kernels

_MAX_N, _MAX_D, _MAX_A, _MAX_POOL = 4, 12, 5, 8
# The step word's candidate field has 12 bits; on such a board the water
# distance is below 4096, so the board value fits its 16 bits.
_MAX_HW = 4096
# Step-table columns (stay, then ActionsMo LEFT, RIGHT, UP, DOWN, whose ids
# are 1..4) and direction-word columns (facings 0..3, then any other).
_MOVES, _FACINGS, _N_ACTIONS = 5, 5, 10
_SW_OK_BIT, _SW_BOARD_SHIFT = 12, 16
_DW_ADIR_SHIFT, _DW_ODIR_SHIFT = 8, 16
# Shared memory a block may take on sm_90 (bytes).
_MAX_SMEM = 232448
# Threads per lane (the lane group, g) of K6/K7: None lets
# ``_lanes_per_group`` choose; chip_smoke.py's sweep and the card tests pin
# values.
_LANES_PER_GROUP = None
_IM_FIELDS = FusedIslandMa.STATE_FIELDS + ("ep_idx",)


class _ImState(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _IM_FIELDS]


class _ImTraj(ctypes.Structure):
    """K7's outputs: the trajectory records ``[T, rows, B]`` and boot."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("feats", "action", "logp", "value", "reward", "done",
                     "boot")
    ]


# The int and float32 scalars of ImParams, in its order.
_IM_FLOATS = (
    "sat0_drink", "sat0_food", "av0_drink", "av0_food",
    "drink_rate", "food_rate", "drink_def_rate", "food_def_rate",
    "drink_def_limit", "food_def_limit", "drink_over_limit",
    "food_over_limit", "drink_def_thresh", "food_def_thresh",
    "drink_over_thresh", "food_over_thresh", "drink_cond_limit",
    "food_cond_limit", "drink_growth_limit", "food_growth_limit",
    "regrowth_exponent",
)
_IM_INTS = (
    "B", "n_steps", "D", "HW", "W", "adm", "odm", "randomize", "amin",
    "amax", "max_iterations", "pool", "stat_lanes", "has_goal", "has_drink",
    "has_food", "has_gold", "has_silver", "has_water", "thirst_death",
    "penalise", "proportional", "sustainability", "drink_limit_on",
    "food_limit_on", "group",
)


class _ImParams(ctypes.Structure):
    """Mirror of ``ImParams`` in ``csrc/fused_island_ma.cu``."""

    _fields_ = [
        ("inp", _ImState),
        ("out", _ImState),
        ("steps", ctypes.c_void_p * _MAX_POOL),
        ("pos0", ctypes.c_void_p * _MAX_POOL),
        ("vcode0", ctypes.c_void_p * _MAX_POOL),
        *[(k, ctypes.c_int) for k in _IM_INTS],
        *[(k, ctypes.c_float) for k in _IM_FLOATS],
        ("rv", (ctypes.c_float * _MAX_D) * len(REWARD_KINDS)),
        ("rv_on", ctypes.c_int * len(REWARD_KINDS)),
        ("dir_word", (ctypes.c_uint32 * _FACINGS) * _N_ACTIONS),
        *[(k, ctypes.c_float) for k in ("inv_w", "inv_hm1", "inv_wm1")],
        ("pol_w", ctypes.c_void_p),
        ("pol_b", ctypes.c_void_p),
        ("pol_eps", ctypes.c_void_p),
        ("pol_lanes", ctypes.c_int),
        *[(k, ctypes.c_void_p) for k in MLP_KEYS],
        ("hidden", ctypes.c_int),
        ("traj", _ImTraj),
    ]


@functools.cache
def _island_lib():
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _cuda.load("fused_island_ma")
    for entry in (lib.fused_island_ma_rollout, lib.fused_island_ma_collect):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    lib.im_params_size.restype = ctypes.c_int
    lib.im_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.im_smem_bytes.restype = ctypes.c_int
    if lib.im_params_size() != ctypes.sizeof(_ImParams):
        raise RuntimeError(
            "ImParams layout differs between fused_island_ma.cu "
            f"({lib.im_params_size()} bytes) and Python "
            f"({ctypes.sizeof(_ImParams)} bytes)"
        )
    return lib


def _move_geometry(h: int, w: int):
    """``(cand, inb)`` [HW, _MOVES] of the bounded move: each cell's
    clamped candidate and whether the unclamped one lies on the board, for
    the stay column and the four moves, as ``FusedIslandMa._step`` computes
    them."""
    cell = np.arange(h * w)
    r, c = cell // w, cell % w
    dr = ACTION_DELTAS_MO[:_MOVES, 0].reshape(1, -1)
    dc = ACTION_DELTAS_MO[:_MOVES, 1].reshape(1, -1)
    cr, cc = r[:, None] + dr, c[:, None] + dc
    inb = (cr >= 0) & (cr < h) & (cc >= 0) & (cc < w)
    cand = np.clip(cr, 0, h - 1) * w + np.clip(cc, 0, w - 1)
    return cand, inb


def _step_words(fused: FusedIslandMa, st: dict = None) -> list:
    """Each layout's step table from the layout statics ``st`` (numpy; by
    default the engine's own), ``[stat_lanes, HW * _MOVES]`` uint32 (one
    row a lane with per-lane layouts): the word of (cell, move column)
    holds the clamped candidate cell (bits 0-11), whether the candidate is
    in bounds and no wall (bit 12) and the static board value ``sboard``
    at the candidate (bits 16-31). Column 0 stays, so its word holds the
    cell's own board value. Raises ``ValueError`` where a board value is
    no integer in [0, 65535]."""
    cand, inb = _move_geometry(fused.h, fused.w)
    st = fused._kstatics_np if st is None else st
    out = []
    for k in range(fused.layout_pool):
        sfx = f"_p{k}" if k else ""
        wall, sboard = st["wall" + sfx], st["sboard" + sfx]  # [HW, L]
        sb = sboard[cand]  # [HW, _MOVES, L]
        if not ((sb == np.round(sb)) & (sb >= 0) & (sb < 65536)).all():
            raise ValueError("a static board value does not fit the step word")
        ok = inb[:, :, None] & ~(wall[cand] > 0.5)
        words = (cand[:, :, None].astype(np.uint32)
                 | (ok.astype(np.uint32) << _SW_OK_BIT)
                 | (sb.astype(np.uint32) << _SW_BOARD_SHIFT))
        out.append(np.ascontiguousarray(
            words.reshape(fused.HW * _MOVES, -1).T))
    return out


def _dir_words(fused: FusedIslandMa) -> np.ndarray:
    """``[10, _FACINGS]`` uint32: the composed direction word of (action,
    facing column; column 4 stands for any facing outside 0..3). Byte 0 is
    the move's step-table column (the absolute action if it moves, else 0),
    byte 1 the new action facing (``action_direction_mode`` != 0), byte 2
    the new observation facing (``observation_direction_mode`` != 0), each
    as ``FusedIslandMa._step`` derives it through ``_table_sel``."""
    if fused.odm == 1:
        otab = MODE_DIR_TABLES[1 if fused.adm in (1, 2) else 0]
    else:
        otab = MODE_DIR_TABLES[2]
    words = np.zeros((_N_ACTIONS, _FACINGS), np.uint32)
    for a in range(_N_ACTIONS):
        for f in range(_FACINGS):
            def sel(table):
                return int(table[a, f]) if f < 4 else 0

            abs_action = a
            if fused.adm != 0 and 1 <= a <= 4:
                rel = sel(MODE_DIR_TABLES[1])
                abs_action = int(DIR_TO_ACTION_MO[rel if 1 <= rel <= 3 else 0])
            move = abs_action if 1 <= abs_action <= 4 else 0
            nad = sel(MODE_DIR_TABLES[fused.adm]) if fused.adm != 0 else 0
            nod = sel(otab) if fused.odm != 0 else 0
            words[a, f] = (move | nad << _DW_ADIR_SHIFT
                           | nod << _DW_ODIR_SHIFT)
    return words


def _static_params(fused: FusedIslandMa, tables: dict) -> _ImParams:
    """The static parameter block: the layouts' device pointers (from
    ``tables``, the device cache or a lane shard's statics, which keeps
    them alive: the step tables under ``_k6_steps``), the flags, the
    float32 constants, the reward vectors, the direction words and the
    features' reciprocals. The state, policy, MLP and trajectory pointers,
    B, n_steps, group and hidden are left at 0."""
    cfg, has = fused.cfg, fused.has
    K = fused.layout_pool
    p = _ImParams()
    for k in range(K):
        sfx = f"_p{k}" if k else ""
        p.steps[k] = tables["_k6_steps"][k].data_ptr()
        for name in ("pos0", "vcode0"):
            getattr(p, name)[k] = tables[name + sfx].data_ptr()
    ints = dict(
        D=fused.D, HW=fused.HW, W=fused.w, adm=fused.adm,
        odm=fused.odm,
        randomize=int(bool(fused.env.randomize_agent_actions_order)),
        amin=fused.amin, amax=fused.amax,
        max_iterations=fused.max_iterations, pool=K,
        stat_lanes=tables["wall"].shape[1],
        has_goal=has["goal"], has_drink=has["drink"], has_food=has["food"],
        has_gold=has["gold"], has_silver=has["silver"],
        has_water=has["water"], thirst_death=fused.thirst_death,
        penalise=cfg["penalise_oversatiation"],
        proportional=cfg["use_satiation_proportional_reward"],
        sustainability=cfg["sustainability_challenge"],
        drink_limit_on=float(cfg["DRINK_OVERSATIATION_LIMIT"]) >= 0,
        food_limit_on=float(cfg["FOOD_OVERSATIATION_LIMIT"]) >= 0,
    )
    for k, v in ints.items():
        setattr(p, k, int(v))
    floats = dict(
        sat0_drink=fused.sat0["drink"], sat0_food=fused.sat0["food"],
        av0_drink=fused.av0["drink"], av0_food=fused.av0["food"],
        drink_rate=cfg["DRINK_EXTRACTION_RATE"],
        food_rate=cfg["FOOD_EXTRACTION_RATE"],
        drink_def_rate=cfg["DRINK_DEFICIENCY_RATE"],
        food_def_rate=cfg["FOOD_DEFICIENCY_RATE"],
        drink_def_limit=cfg["DRINK_DEFICIENCY_LIMIT"],
        food_def_limit=cfg["FOOD_DEFICIENCY_LIMIT"],
        drink_over_limit=cfg["DRINK_OVERSATIATION_LIMIT"],
        food_over_limit=cfg["FOOD_OVERSATIATION_LIMIT"],
        drink_def_thresh=cfg["DRINK_DEFICIENCY_THRESHOLD"],
        food_def_thresh=cfg["FOOD_DEFICIENCY_THRESHOLD"],
        drink_over_thresh=cfg["DRINK_OVERSATIATION_THRESHOLD"],
        food_over_thresh=cfg["FOOD_OVERSATIATION_THRESHOLD"],
        drink_cond_limit=fused.drink_cond_limit,
        food_cond_limit=cfg["FOOD_GROWTH_LIMIT"],
        drink_growth_limit=cfg["DRINK_GROWTH_LIMIT"],
        food_growth_limit=cfg["FOOD_GROWTH_LIMIT"],
        # Faithful reference quirk: drink and food regrow with the DRINK
        # exponent.
        regrowth_exponent=cfg["DRINK_REGROWTH_EXPONENT"],
    )
    for k in _IM_FLOATS:
        setattr(p, k, _f32(float(floats[k])))
    for r, kind in enumerate(REWARD_KINDS):
        vec = fused.rv[kind]
        if vec is not None:
            p.rv_on[r] = 1
            for d in range(fused.D):
                p.rv[r][d] = float(vec[d, 0])
    words = _dir_words(fused)
    for a in range(_N_ACTIONS):
        for f in range(_FACINGS):
            p.dir_word[a][f] = int(words[a, f])
    # The features' reciprocals, rounded to float32 as the reference rounds
    # them (fused_base._pos_dir_feats).
    p.inv_w = _f32(1.0 / fused.w)
    p.inv_hm1 = _f32(1.0 / max(fused.h - 1, 1))
    p.inv_wm1 = _f32(1.0 / max(fused.w - 1, 1))
    return p


def _stat_lanes(fused) -> int:
    """1 when every lane shares the layouts, else B (per-lane layouts)."""
    return fused._kstatics_np["wall"].shape[1]


def _smem_bytes(fused: FusedIslandMa, g: int, threads: int,
                hidden: int = 0) -> int:
    """Shared memory of a K6 block (K7 with ``hidden`` MLP units) of
    ``threads`` threads in g-thread lane groups, as ``im_smem`` in
    ``csrc/fused_island_ma.cu`` lays it out (the card test holds them equal
    through ``im_smem_bytes``): the reward vectors, the direction words, the
    step tables (the pool's, or one a lane with per-lane layouts), K7's MLP
    weights, and each lane's reward sums and K7's buffers of hidden units,
    output rows and the step's rewards."""
    lanes = threads // g
    A = fused.amax - fused.amin + 1
    table = fused.HW * _MOVES
    words = len(REWARD_KINDS) * _MAX_D + _N_ACTIONS * _FACINGS
    if _stat_lanes(fused) != 1:
        words += lanes * (table | 1)  # lanes' tables an odd number apart
    else:
        words += fused.layout_pool * table
    per_lane = fused.n * fused.D
    if hidden:
        words += (hidden * fused.POLICY_FEATURES + hidden
                  + (A + 1) * (hidden + 1) + A + 1)
        per_lane += fused.n * (hidden + 1 + A + 1 + fused.D)
    return 4 * (words + lanes * (per_lane | 1))


def _geometry(fused, g, tile, hidden=0):
    """``(threads, shared bytes)`` of a K6/K7 block of g-thread lane groups:
    ``tile`` threads, or by default a block of 32 lanes (at most 256
    threads) halved while it does not fit the shared memory."""
    threads = tile
    if threads is None:
        threads = min(256, 32 * g)
        while threads > 32 and _smem_bytes(fused, g, threads, hidden) > _MAX_SMEM:
            threads //= 2
    return threads, _smem_bytes(fused, g, threads, hidden)


# (largest g, least g, warps a scheduler) of the lane group of K6 and of K7
# (chip_smoke.py's group-size sweep on the H100, PERF.md): K6 alone up to 4
# warps a scheduler; K7 up to 2, and at least 2 threads a lane, whose warps
# then hold 16 lanes' MLP buffers in place of 32.
_GROUP_RANGE = {"rollout": (16, 1, 4), "collect": (16, 2, 2)}


def _lanes_per_group(fused, B: int, tile=None, hidden: int = 0,
                     schedulers: int = _H100_SCHEDULERS) -> int:
    """g, the threads of the lane group that runs each lane of K6 (or of K7
    with ``hidden`` MLP units), a power of two dividing 32, from the batch
    ``B``, the mode and the agents' and reward dims' counts.

    A lane's steps are one dependent chain, which its group runs together:
    the reward rows (D dims) split over the g threads, and in K7 the MLP's
    output rows (N agents x (A + 1)) and hidden units too; the scalar part
    runs on all of them. The largest g of the mode's range
    (``_GROUP_RANGE``), and no more than the split can use (D rounded up to
    a power of two in K6, N (A + 1) in K7), whose ceil(B * g / 32) warps fit
    the range's count to each of the card's ``schedulers``, and at least
    the range's least g: more threads a lane shorten the chain while the
    card has room for the warps, fewer keep the redundant scalar part small
    once it has none. Then g doubles while a block of ``tile`` threads
    (``_geometry``) does not fit the shared memory. ``_LANES_PER_GROUP``
    pins g."""
    g = _LANES_PER_GROUP
    if g is None:
        A = fused.amax - fused.amin + 1
        top, least, per_scheduler = _GROUP_RANGE["collect" if hidden else "rollout"]
        split = fused.n * (A + 1) if hidden else fused.D
        top = min(top, 1 << (split - 1).bit_length())  # split's power of two
        g = next((k for k in (16, 8, 4, 2)
                  if k <= top and -(-B * k // 32) <= per_scheduler * schedulers),
                 1)
        g = max(g, least)
    while g < 32 and _geometry(fused, g, tile, hidden)[1] > _MAX_SMEM:
        g *= 2
    return g


def _block(fused, B, tile, hidden=0, schedulers=_H100_SCHEDULERS):
    """``(g, threads, shared bytes)`` of a K6/K7 launch at batch ``B``;
    raises ``ValueError`` when no lane group fits a block of ``tile``
    threads."""
    g = _lanes_per_group(fused, B, tile, hidden, schedulers)
    threads, smem = _geometry(fused, g, tile, hidden)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the island_ma kernels' shared memory ({smem} bytes) does not "
            f"fit a block of {threads} threads"
        )
    return g, threads, smem


def check_static_limits(fused, tile=None) -> None:
    """Raise ``NotImplementedError`` for what K6 and K7 lack whatever the
    state: more than 4 agents, 12 reward dims or 5 actions, a layout pool
    of more than 8, boards of more than 4096 cells, and (once the layouts
    are drawn) step tables that fit no block of ``tile`` threads even at
    32 threads a lane. ``init_packed`` calls it on a CUDA device, so that
    ``BatchedEnv(..., backend="auto")`` takes the generic path for such a
    configuration; the plain version runs all of them."""
    if not 1 <= fused.n <= _MAX_N:
        raise NotImplementedError(
            f"the island_ma kernels take 1..{_MAX_N} agents, not {fused.n}"
        )
    if fused.D > _MAX_D or fused.amax - fused.amin + 1 > _MAX_A:
        raise NotImplementedError(
            f"the island_ma kernels take at most {_MAX_D} reward dims and "
            f"{_MAX_A} actions"
        )
    if fused.layout_pool > _MAX_POOL:
        raise NotImplementedError(
            f"the island_ma kernels take a layout pool of at most {_MAX_POOL}"
        )
    if fused.HW > _MAX_HW:
        raise NotImplementedError(
            f"the island_ma kernels take boards of at most {_MAX_HW} cells"
        )
    if fused._kstatics_np and _geometry(fused, 32, tile)[1] > _MAX_SMEM:
        raise NotImplementedError(
            "the island_ma kernels' step tables fit no block of "
            f"{tile or 32} threads"
        )


def _check_launch(fused, S, n_steps, tile, hidden=0, tables=None):
    """The checks both kernels share; returns ``(device, B, n_steps,
    block)`` with ``block`` from ``_block``. Configurations the kernels
    lack raise ``NotImplementedError``, bad inputs ``ValueError``, both
    before any launch; the layouts' lanes are read from ``tables``
    (``FusedMaBase._launch_tables``; by default the device cache)."""
    device = S["t"].device
    if device.type != "cuda":
        raise NotImplementedError(f"no island_ma kernel for {device}")
    check_static_limits(fused)
    if not fused._kstatics_np:
        raise ValueError("call init_packed before launching the kernels")
    B, n_steps = check_kernel_state(
        fused, S, n_steps, 32 if tile is None else tile,
        max(fused.HW, fused.n * fused.D, fused.n * 5),
    )
    fused._check_statics_batch(
        fused._on(device) if tables is None else tables, B)
    if B * fused.HW * _MOVES >= 2**31:
        raise ValueError(f"batch {B} too large for 32-bit indexing")
    from ai_safety_gridworlds_torch.ops.fused_scalar import _schedulers

    return device, B, n_steps, _block(fused, B, tile, hidden,
                                      _schedulers(str(device)))


def _params(fused, S, out, device, tables) -> _ImParams:
    """A copy of the static block cached in ``tables`` (the device cache or
    a lane shard's statics) with this call's state pointers."""
    if "_k6_params" not in tables:
        if tables is fused._on(device):
            st = fused._kstatics_np
        else:
            st = {k: tables[k].cpu().numpy() for k in fused._kstatics_np}
        tables["_k6_steps"] = [
            torch.from_numpy(w.view(np.int32)).to(device)
            for w in _step_words(fused, st)
        ]
        tables["_k6_params"] = _static_params(fused, tables)
    p = _ImParams.from_buffer_copy(tables["_k6_params"])
    for name in fused.STATE_FIELDS:
        setattr(p.inp, name, S[name].data_ptr())
        setattr(p.out, name, out[name].data_ptr())
    p.B = S["t"].shape[1]
    return p


def fused_island_ma_rollout(fused: FusedIslandMa, S: dict, n_steps: int,
                            tile=FusedIslandMa.DEFAULT_TILE,
                            statics=None) -> dict:
    """Advance a packed CUDA state ``n_steps`` steps with one launch of K6
    (``csrc/fused_island_ma.cu``); returns a new state dict. The policy
    installed by ``set_policies`` at the time of the call picks the actions
    (K6's linear branch); without one the draws are uniform.

    ``tile`` is the threads per block (a multiple of 32 in [32, 256]);
    each lane runs on a group of ``_lanes_per_group`` threads, so a block
    holds ``tile // g`` lanes. None sizes a block of 32 lanes. ``statics``
    (the layouts and the policy) as for :meth:`FusedMaBase.rollout`.

    Checks every field's device, dtype, shape and contiguity and raises on
    what the kernel does not take; CPU tensors take the plain version."""
    if S["t"].device.type == "cpu":
        return fused.rollout_plain(S, n_steps, statics)
    tables = fused._launch_tables(S["t"].device, statics)
    device, B, n_steps, block = _check_launch(fused, S, n_steps, tile,
                                              tables=tables)
    if statics is None:
        statics = fused._all_statics(device)
    fused._check_statics_batch(statics, B)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    if n_steps == 0:
        for k in out:
            out[k].copy_(S[k])
        return out
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _island_lib()
    p = _params(fused, S, out, device, tables)
    if "pol_w" in statics:
        for k in POLICY_KEYS:
            setattr(p, k, statics[k].data_ptr())
        p.pol_lanes = statics["pol_w"].shape[1]
    p.n_steps = n_steps
    p.group, threads, _ = block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_island_ma_rollout(
            ctypes.byref(p), fused.n, threads, stream
        )
    fused_island_ma_rollout.launches += 1
    _cuda.check(lib, err, "fused_island_ma_rollout launch")
    return out


fused_island_ma_rollout.launches = 0


def fused_island_ma_collect(fused: FusedIslandMa, S: dict, params: dict,
                            n_steps: int, tile=FusedIslandMa.DEFAULT_TILE,
                            statics=None):
    """The PPO collection: ``n_steps`` steps under the MLP policy
    ``params`` with one launch of K7 (``csrc/fused_island_ma.cu``);
    ``tile`` as for :func:`fused_island_ma_rollout`.

    Returns ``(S, traj, boot)`` as :meth:`FusedMaBase.rollout_collect`:
    ``traj[name]`` is ``[n_steps, rows, B]``, ``boot`` is ``[n, B]``.
    Checks the state as K6 does and each MLP tensor's device, dtype, shape
    and contiguity (``mlp_w1`` [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1,
    H], ``mlp_b2`` [A+1, 1], float32 on the state's device); CPU tensors
    take the plain version. ``statics`` (K7 reads their layouts) as for
    :meth:`FusedMaBase.rollout`."""
    if S["t"].device.type == "cpu":
        return fused.rollout_collect_plain(S, params, n_steps, statics)
    if S["t"].device.type != "cuda":
        raise NotImplementedError(f"no island_ma kernel for {S['t'].device}")
    H = check_mlp_params(fused, params, S["t"].device)
    tables = fused._launch_tables(S["t"].device, statics)
    device, B, n_steps, block = _check_launch(fused, S, n_steps, tile, H,
                                              tables)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    traj = {
        name: torch.empty((n_steps, rows, B), dtype=dtype, device=device)
        for name, rows, dtype in fused._traj_layout()
    }
    boot = torch.empty((fused.n, B), dtype=_F32, device=device)
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _island_lib()
    p = _params(fused, S, out, device, tables)
    for k in MLP_KEYS:
        setattr(p, k, params[k].data_ptr())
    for name in traj:
        setattr(p.traj, name, traj[name].data_ptr())
    p.traj.boot = boot.data_ptr()
    p.n_steps, p.hidden = n_steps, H
    p.group, threads, _ = block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_island_ma_collect(
            ctypes.byref(p), fused.n, threads, stream
        )
    fused_island_ma_collect.launches += 1
    _cuda.check(lib, err, "fused_island_ma_collect launch")
    return out, traj, boot


fused_island_ma_collect.launches = 0
