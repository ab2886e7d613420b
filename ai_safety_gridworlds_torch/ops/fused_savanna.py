"""Fused batched aintelope_savanna rollout and PPO collection: plain PyTorch
body and CUDA kernels.

Port of ``ai_safety_gridworlds_tpu/ops/fused_savanna.py``. The whole
multi-agent step -- the auto-reset (with the per-episode map redraw under
``exact_reset``), action draws, randomized agent order, every agent's
sub-step (relative direction updates, the move with agents blocking each
other, resource consumption, satiation homeostasis and thirst/hunger death,
gold and silver log rewards, gap visits, safety distances to water and
predators, the water penalty, the predator random walk, the sustainability
drapes) and finalize -- runs over the packed layout: batch lanes on the last
axis, boards ``[HW, B]``, positions flat cell indices ``[n_agents, B]``.

Draw sites per step (``ctr0 = draw_ctr * n_sites``, uint32 wrap): 0 the
actions, 1 the agent order, then per slot the predator site ``2 + slot *
sites_per_slot`` and, under ``sustainability_challenge``, one site per
resource after it; the redraw takes site ``2 + n * sites_per_slot`` when
``exact_reset`` is on. Every per-cell word is ``hash_u32(key, ctr0 + site,
cell)``.

Two implementations of the same step:

* ``FusedSavanna._step``, the plain PyTorch version, which mirrors the JAX
  step op for op (boards are read by index where JAX sums a one-hot product
  with a single nonzero term; the value is the same). ``rollout`` and
  ``rollout_collect`` run it for CPU tensors; tests and the on-card
  comparison run it anywhere through ``rollout_plain``,
  ``rollout_collect_plain`` and ``step``.
* The hand-written CUDA kernels of ``csrc/fused_savanna.cu``, which
  ``rollout`` and ``rollout_collect`` launch for CUDA tensors, one launch per
  call: :func:`fused_savanna_rollout` (K8; uniform or linear-policy actions)
  and :func:`fused_savanna_collect` (K9; MLP actions and the streamed
  trajectory).

Under ``sustainability_challenge`` the regrowth computes ``exp(e * log(av +
1))`` and takes its ceiling as the tile count of the curtain.
``torch.exp``/``torch.log`` on the CPU may round differently from XLA's, so
the plain step reports ``regrow_gap`` in its draws: the least distance of a
regrown availability from an integer, under which such a rounding can flip
the ceiling. The gold and silver rewards take ``log`` too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.actions import (
    ACTION_DELTAS_MO,
    DIR_TO_ACTION_MO,
    REL_MOVE_DIR,
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

_I32 = torch.int32
_F32 = torch.float32

QUIT_R = int(TerminationReason.QUIT)
TERMINATED_R = int(TerminationReason.TERMINATED)
NOOP = int(ActionsMo.NOOP)
QUIT = int(ActionsMo.QUIT)
UP_DIR = int(Directions.UP)

# Tile-code ids of the combined static board: exactly one char per cell, so
# the codes are mutually exclusive.
TILE_CODES = {
    "gap": 0, "wall": 1, "water": 2, "gold": 3, "silver": 4,
    "drink": 5, "food": 6, "small_drink": 7, "small_food": 8,
}

# The resources in the step's order.
RESOURCES = ("drink", "food", "small_drink", "small_food")

# Reward constants, in the order the CUDA kernel indexes them.
REWARD_KINDS = (
    "MOVEMENT_SCORE", "GAP_SCORE", "DRINK_SCORE", "FOOD_SCORE",
    "SMALL_DRINK_SCORE", "SMALL_FOOD_SCORE", "NON_DRINK_SCORE",
    "NON_FOOD_SCORE", "GOLD_SCORE", "SILVER_SCORE", "DANGER_TILE_SCORE",
    "PREDATOR_NPC_SCORE", "THIRST_HUNGER_DEATH_SCORE", "COOPERATION_SCORE",
    "SMALL_COOPERATION_SCORE", "DRINK_DEFICIENCY_SCORE",
    "FOOD_DEFICIENCY_SCORE", "DRINK_OVERSATIATION_SCORE",
    "FOOD_OVERSATIATION_SCORE",
)

# Integer scores of the redraw and the drapes: candidates are below
# OFF_PLAYER (drape removal puts player cells at + OFF_PLAYER), SENT marks a
# non-candidate.
OFF_PLAYER = 1 << 29
SENT = 1 << 30


def _lut_select(table_1d, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``table[idx]`` for a tiny static table; indices outside ``lo..hi-1``
    read ``table[lo]``, as the reference's select chain does."""
    out = torch.full_like(idx, int(table_1d[lo]))
    for v in range(lo + 1, hi):
        out = torch.where(idx == v, int(table_1d[v]), out)
    return out


def _read(board: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A board ``[rows, B]`` read at each lane's row ``idx`` [1, B]."""
    return board.gather(0, idx.long())


class FusedSavanna(FusedMaBase):
    """Packed batched aintelope_savanna with a single-kernel rollout."""

    # Threads per block of the CUDA kernels; None lets the wrappers size a
    # block of 32 lanes (``_block``).
    DEFAULT_TILE = None
    # Per-agent policy features: normalised row and column, drink and food
    # satiation, water and predator safety distances, the observation-
    # direction one-hot.
    POLICY_FEATURES = 10

    STATE_FIELDS = (
        "pos", "predator", "reasons", "step_types", "act_dir", "obs_dir",
        "step_count", "drink_sat", "food_sat", "visits", "safety",
        "safety2", "t", "key", "draw_ctr", "stats_rewards",
        "stats_episodes",
    )

    def __init__(self, env):
        from ai_safety_gridworlds_torch.envs import aintelope_savanna as E

        self.env = env
        self.n = env.n_agents
        self.D = env.reward_space.n_dims
        h, w = env.h, env.w
        self.h, self.w, self.HW = h, w, h * w
        wall0 = np.asarray(env._wall_mask0)
        if not (wall0[0, :].all() and wall0[-1, :].all()
                and wall0[:, 0].all() and wall0[:, -1].all()):
            raise NotImplementedError(
                "fused predator stencil requires an all-wall border"
            )
        cfg = env.cfg
        self.cfg = cfg
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)
        self.pred_move_p = float(cfg["PREDATOR_MOVEMENT_PROBABILITY"])

        # Reward vectors tiled over the [n*D] reward rows; an all-zero
        # vector (or one the reward space does not enable) drops its term.
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
        vrows = np.arange(self.n * 7, dtype=np.int32)
        self.consts = {
            "row_agent": row_agent.reshape(-1, 1).astype(np.float32),
            "vrow_agent": (vrows // 7).reshape(-1, 1),
            "vrow_col": (vrows % 7).reshape(-1, 1),
        }
        for k, v in self.rv.items():
            if v is not None:
                self.consts["rv_" + k] = v
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )
        cells = np.arange(self.HW, dtype=np.int32)
        self.consts["cell_row"] = (cells // w).reshape(-1, 1)
        self.consts["cell_col"] = (cells % w).reshape(-1, 1)

        # --- sustainability: dynamic resource curtains
        self.sustain = bool(cfg["sustainability_challenge"])
        exp_ = float(cfg["DRINK_REGROWTH_EXPONENT"])
        # The usable // 2 regrowth clamp: the count-enforced shuffle keeps
        # the wall count, so it is a constant of the config.
        base_b = np.asarray(env._base_board, np.uint8).copy()
        for tile_type, max_count in env.tile_type_counts.items():
            locs = np.argwhere(base_b == ord(tile_type))
            for r, c in locs[max_count:]:
                base_b[r, c] = ord(E.GAP_CHR)
        usable_half_c = float(
            (base_b.size - int((base_b == ord(E.WALL_CHR)).sum())) // 2
        )

        def k_bounds(growth_limit, cond_limit, rate):
            """The static pick bounds: the largest rise (spawn) and fall
            (removal) of the integer availability in one sub-step over the
            regrowth map, on top of the extraction rate."""
            af = np.linspace(1.0, float(cond_limit), 4096, endpoint=False)
            grown = np.minimum(float(growth_limit), (af + 1.0) ** exp_)
            grown = np.minimum(grown, usable_half_c)
            rise = int(np.max(np.ceil(grown) - np.ceil(af)))
            fall = int(np.max(np.ceil(af) - np.ceil(grown)))
            k_spawn = max(1, rise) + 1
            k_rem = max(int(np.ceil(rate)), fall, 1) + 1
            return k_rem, k_spawn

        drink_metric = cfg[
            "use_drink_availability_metric_instead_of_spawning_tiles"]
        food_metric = cfg[
            "use_food_availability_metric_instead_of_spawning_tiles"]
        drink_cond = float(E.DEFAULTS["DRINK_GROWTH_LIMIT"])
        food_cond = float(cfg["FOOD_GROWTH_LIMIT"])
        self.res_specs = []
        for name, enabled, rate, use_metric, glk, cond in (
            ("drink", env._has_drink, float(cfg["DRINK_EXTRACTION_RATE"]),
             drink_metric, "DRINK_GROWTH_LIMIT", drink_cond),
            ("food", env._has_food, float(cfg["FOOD_EXTRACTION_RATE"]),
             food_metric, "FOOD_GROWTH_LIMIT", food_cond),
            ("small_drink", env._has_small_drink,
             float(cfg["SMALL_DRINK_EXTRACTION_RATE"]), drink_metric,
             "DRINK_GROWTH_LIMIT", drink_cond),
            ("small_food", env._has_small_food,
             float(cfg["SMALL_FOOD_EXTRACTION_RATE"]), food_metric,
             "FOOD_GROWTH_LIMIT", food_cond),
        ):
            if not enabled:
                continue
            k_rem, k_spawn = k_bounds(cfg[glk], cond, rate)
            self.res_specs.append({
                "name": name,
                "rate": rate,
                "use_metric": bool(use_metric),
                "growth_limit": float(cfg[glk]),
                "cond_limit": cond,
                "amount": float(self._amount_for(name)),
                "k_rem": k_rem,
                "k_spawn": k_spawn,
            })
        if self.sustain:
            extra = []
            for spec in self.res_specs:
                extra += [f"res_{spec['name']}", f"avail_{spec['name']}"]
            self.STATE_FIELDS = type(self).STATE_FIELDS + tuple(extra)

        # Draw sites per step: 0 actions, 1 order, then per slot the
        # predator site and (sustainability) one site per resource drape.
        self.sites_per_slot = 1 + (len(self.res_specs) if self.sustain else 0)
        self.n_sites = 2 + self.n * self.sites_per_slot
        self.tile_codes = dict(TILE_CODES)

        # --- the per-episode redraw: the trimmed base board's interior
        # tiles in a fixed type order, plus the top-up deficits; walls last.
        interior_b = base_b[1:-1, 1:-1]
        topup = {}
        for chr_, deficit in getattr(env, "_reset_topup", ()):
            topup[chr_] = topup.get(chr_, 0) + int(deficit)

        def icnt(ch):
            return int((interior_b == ord(ch)).sum())

        spec = []
        self._exact_ok = True
        self._exact_why = ""
        for j, c in enumerate(env.agent_chars):
            if icnt(c) != 1:
                self._exact_ok = False
                self._exact_why = f"agent {c!r} not in the board interior"
            spec.append(("agent", j))
        spec += [("predator", None)] * icnt(E.PREDATOR_NPC_CHR)
        spec += [("water", None)] * icnt(E.DANGER_TILE_CHR)
        spec += [("gold", None)] * icnt(E.GOLD_CHR)
        spec += [("silver", None)] * icnt(E.SILVER_CHR)
        for name, ch in (
            ("drink", E.DRINK_CHR), ("food", E.FOOD_CHR),
            ("small_drink", E.SMALL_DRINK_CHR),
            ("small_food", E.SMALL_FOOD_CHR),
        ):
            spec += [(name, None)] * (icnt(ch) + topup.get(ch, 0))
        spec += [("wall", None)] * icnt(E.WALL_CHR)
        self._placement_spec = tuple(spec)
        known = {
            ord(ch) for ch in (
                E.GAP_CHR, E.WALL_CHR, E.PREDATOR_NPC_CHR, E.DANGER_TILE_CHR,
                E.GOLD_CHR, E.SILVER_CHR, E.DRINK_CHR, E.FOOD_CHR,
                E.SMALL_DRINK_CHR, E.SMALL_FOOD_CHR,
            )
        } | {ord(c) for c in env.agent_chars}
        if not set(np.unique(interior_b)) <= known:
            self._exact_ok = False
            self._exact_why = "board interior has unsupported tile chars"
        # The redraw rebuilds the border as all wall: a non-wall border
        # tile would vanish on the first auto-reset.
        border = base_b.copy()
        border[1:-1, 1:-1] = ord(E.WALL_CHR)
        if not (border == ord(E.WALL_CHR)).all():
            self._exact_ok = False
            self._exact_why = "board border is not all-wall"
        # Distinct integer scores: rank bits << idx bits | cell index.
        self._idx_bits = max(9, int(self.HW - 1).bit_length())
        self.redraw_site = 2 + self.n * self.sites_per_slot
        self.exact_reset = False  # set by init_packed
        if self._exact_ok:
            rr2, cc2 = cells // w, cells % w
            interior_m = (rr2 >= 1) & (rr2 <= h - 2) & (cc2 >= 1) & (cc2 <= w - 2)
            self.consts["interior"] = interior_m.astype(np.float32).reshape(-1, 1)
            self.consts["border_wall"] = (~interior_m).astype(
                np.float32).reshape(-1, 1)
        self.layout_pool = 1
        self.packed_batch = None
        self._kstatics_np = {}
        self._device_cache = {}

    def _amount_for(self, ckey: str) -> int:
        return {
            "drink": self.cfg["amount_drink_holes"],
            "food": self.cfg["amount_food_patches"],
            "small_drink": self.cfg["amount_small_drink_holes"],
            "small_food": self.cfg["amount_small_food_patches"],
        }[ckey]

    def field_spec(self, name):
        """(rows, dtype) of a packed state field."""
        n, HW = self.n, self.HW
        if name.startswith("res_"):
            return HW, _F32
        if name.startswith("avail_"):
            return 1, _F32
        return {
            "pos": (n, _I32), "predator": (HW, _F32), "reasons": (n, _I32),
            "step_types": (n, _I32), "act_dir": (n, _I32),
            "obs_dir": (n, _I32), "step_count": (n, _I32),
            "drink_sat": (n, _F32), "food_sat": (n, _F32),
            "visits": (n * 7, _I32), "safety": (n, _I32),
            "safety2": (n, _I32), "t": (1, _I32), "key": (2, torch.uint32),
            "draw_ctr": (1, torch.uint32),
            "stats_rewards": (n * self.D, _F32),
            "stats_episodes": (1, _I32), "ep_idx": (1, _I32),
            "wall": (HW, _F32), "sboard": (HW, _F32),
        }[name]

    # ------------------------------------------------------------- packing

    def init_packed(self, seed: int, batch: int, device, layout_pool: int = 1,
                    exact_reset=None, tile=None) -> dict:
        """The packed initial state of ``batch`` lanes on ``device``; equal
        field by field, and in the statics ``_kstatics_np``, to the JAX
        package's ``init_packed(seed, batch, layout_pool, exact_reset)``.

        Each lane draws its layout on the host (the interior shuffle from
        ``PCG64(seed ^ 0x5AFA)`` and the GAP-only top-up). ``exact_reset``
        (default: on when the config randomizes every episode and
        ``layout_pool == 1``) redraws each lane's map from the PRF at every
        auto-reset, and the layout boards ``wall`` and ``sboard`` become
        state; ``layout_pool=K > 1`` draws K layouts per lane instead and
        the auto-reset cycles them per episode.

        On a CUDA device a configuration that K8 and K9 lack whatever the
        state raises ``NotImplementedError`` here (``check_static_limits``
        at ``tile``, the launches' threads per block)."""
        from ai_safety_gridworlds_torch.envs.aintelope_savanna import GAP_CHR

        env = self.env
        n, HW = self.n, self.HW
        K = int(layout_pool)
        if K < 1:
            raise ValueError("layout_pool must be >= 1")
        if K > 1 and not env.cfg["map_randomization_frequency"] >= 1:
            raise ValueError(
                "layout_pool > 1 requires map_randomization_frequency >= 1"
            )
        if exact_reset is None:
            exact_reset = (
                K == 1 and self._exact_ok
                and env.cfg["map_randomization_frequency"] >= 3
            )
        elif exact_reset:
            if K > 1:
                raise ValueError(
                    "exact_reset and layout_pool are mutually exclusive"
                )
            if not self._exact_ok:
                raise ValueError(
                    f"exact_reset unsupported here: {self._exact_why}"
                )
        self.exact_reset = bool(exact_reset)
        # The redraw takes one more site; the other sites keep their
        # numbers.
        self.n_sites = (
            2 + n * self.sites_per_slot + (1 if self.exact_reset else 0)
        )
        base = np.asarray(env._base_board, np.uint8).copy()
        for tile_type, max_count in env.tile_type_counts.items():
            locs = np.argwhere(base == ord(tile_type))
            for r, c in locs[max_count:]:
                base[r, c] = ord(GAP_CHR)
        rng = np.random.Generator(np.random.PCG64(seed ^ 0x5AFA))
        interior = base[1:-1, 1:-1].reshape(-1)
        hi, wi = base.shape[0] - 2, base.shape[1] - 2

        def draw_boards():
            boards = np.tile(base.reshape(-1), (batch, 1))  # [B, HW]
            if env.cfg["map_randomization_frequency"] >= 1:
                inner = np.tile(interior, (batch, 1))
                idx = rng.permuted(
                    np.tile(np.arange(interior.size), (batch, 1)), axis=1
                )
                inner = np.take_along_axis(inner, idx, axis=1)
                grid = boards.reshape(batch, *base.shape)
                grid[:, 1:-1, 1:-1] = inner.reshape(batch, hi, wi)
                boards = grid.reshape(batch, HW)
            # The art-vs-flag top-up: the missing resource tiles go to
            # random GAP cells of each lane.
            for chr_, deficit in getattr(env, "_reset_topup", ()):
                gap = boards == ord(GAP_CHR)
                free = int(gap.sum(axis=1).min())
                if free < deficit:
                    raise ValueError(
                        f"cannot top up {deficit} {chr(ord(chr_))!r} "
                        f"tiles: a lane has only {free} free cells -- "
                        "reduce the amount_* flags or enlarge the map"
                    )
                score = np.where(gap, rng.random(boards.shape), 2.0)
                pick = np.argpartition(score, deficit - 1, axis=1)[:, :deficit]
                np.put_along_axis(boards, pick, ord(chr_), axis=1)
            return boards.T  # [HW, B]

        pools = [self._layout_statics(draw_boards()) for _ in range(K)]
        statics, kstatics = pools[0]
        for k in range(1, K):
            for key_, v in pools[k][1].items():
                kstatics[key_ + f"_p{k}"] = v
        self.layout_pool = K
        self._statics_np_pool = [p[0] for p in pools]

        cfg = env.cfg
        self.sat0 = {
            "drink": float(
                cfg["DRINK_DEFICIENCY_INITIAL"] if env._drink_flags_on else 0.0
            ),
            "food": float(
                cfg["FOOD_DEFICIENCY_INITIAL"] if env._food_flags_on else 0.0
            ),
        }
        state = {
            "pos": torch.from_numpy(statics["pos0"].copy()),
            "predator": torch.from_numpy(statics["predator0"].copy()),
            "reasons": torch.full((n, batch), NONE, dtype=_I32),
            "step_types": torch.full((n, batch), FIRST, dtype=_I32),
            "act_dir": torch.full((n, batch), UP_DIR, dtype=_I32),
            "obs_dir": torch.full((n, batch), UP_DIR, dtype=_I32),
            "step_count": torch.zeros((n, batch), dtype=_I32),
            "drink_sat": torch.full((n, batch), self.sat0["drink"], dtype=_F32),
            "food_sat": torch.full((n, batch), self.sat0["food"], dtype=_F32),
            "visits": torch.zeros((n * 7, batch), dtype=_I32),
            "safety": torch.full((n, batch), 3, dtype=_I32),
            "safety2": torch.full((n, batch), 3, dtype=_I32),
            "t": torch.zeros((1, batch), dtype=_I32),
            "key": torch.from_numpy(prng.derive_keys(seed, batch)),
            "draw_ctr": torch.zeros((1, batch), dtype=torch.uint32),
            "stats_rewards": torch.zeros((n * self.D, batch), dtype=_F32),
            "stats_episodes": torch.zeros((1, batch), dtype=_I32),
        }
        if self.sustain:
            for spec in self.res_specs:
                state["res_" + spec["name"]] = torch.from_numpy(
                    statics[spec["name"]].copy()
                )
                state["avail_" + spec["name"]] = torch.full(
                    (1, batch), spec["amount"], dtype=_F32
                )
        fields = tuple(
            f for f in self.STATE_FIELDS if f not in ("ep_idx", "wall", "sboard")
        )
        if K > 1:
            state["ep_idx"] = torch.zeros((1, batch), dtype=_I32)
            fields = fields + ("ep_idx",)
        if self.exact_reset:
            # The redraw makes the layout per-lane state; the reset-only
            # statics drop out (usable_half stays: wall counts are
            # invariant).
            state["wall"] = torch.from_numpy(statics["wall"].copy())
            state["sboard"] = torch.from_numpy(kstatics["sboard"].copy())
            fields = fields + ("wall", "sboard")
            for k in ("wall", "sboard", "pos0", "predator0"):
                kstatics.pop(k, None)
            for spec in self.res_specs:
                kstatics.pop("res0_" + spec["name"], None)
        self.STATE_FIELDS = fields
        self._statics_np = statics
        self._kstatics_np = kstatics
        self.packed_batch = int(batch)
        self._device_cache = {}
        if torch.device(device).type == "cuda":
            check_static_limits(self, tile)
        return {k: v.to(device) for k, v in state.items()}

    def _layout_statics(self, boards):
        """Per-layout boards: the host mask set and the kernel statics (the
        combined code/distance board, walls, start positions, predators,
        the sustainability curtains and the regrowth clamp)."""
        from ai_safety_gridworlds_torch.envs import aintelope_savanna as E

        env = self.env
        n, HW = self.n, self.HW
        batch = boards.shape[1]

        def mask(chr_):
            return (boards == ord(chr_)).astype(np.float32)

        statics = {
            "wall": mask(E.WALL_CHR),
            "water": mask(E.DANGER_TILE_CHR),
            "gold": mask(E.GOLD_CHR),
            "silver": mask(E.SILVER_CHR),
            "drink": mask(E.DRINK_CHR),
            "food": mask(E.FOOD_CHR),
            "small_drink": mask(E.SMALL_DRINK_CHR),
            "small_food": mask(E.SMALL_FOOD_CHR),
            "predator0": mask(E.PREDATOR_NPC_CHR),
        }
        pos0 = np.zeros((n, batch), np.int32)
        for i, c in enumerate(env.agent_chars):
            pos0[i] = np.argmax(boards == ord(c), axis=0)
        statics["pos0"] = pos0
        # Tile code + 16 * min-Manhattan distance to water; start and
        # predator cells read as gap.
        code = np.zeros((HW, batch), np.float32)
        res_names = {spec["name"] for spec in self.res_specs}
        for name, cid in self.tile_codes.items():
            if self.sustain and name in res_names:
                continue  # dynamic curtains, not static codes
            if cid:
                code += cid * statics[name]
        if env._has_water:
            dist = min_water_dist(statics["water"] > 0.5, self.h, self.w)
        else:
            dist = np.full((HW, batch), 99, np.int32)
        sboard = code + 16.0 * dist.astype(np.float32)
        kstatics = {
            "wall": statics["wall"],
            "predator0": statics["predator0"],
            "pos0": pos0,
            "sboard": sboard,
        }
        if self.sustain:
            for spec in self.res_specs:
                kstatics["res0_" + spec["name"]] = statics[spec["name"]]
            kstatics["usable_half"] = (
                (HW - statics["wall"].sum(axis=0, keepdims=True)) // 2
            ).astype(np.float32)
        return statics, kstatics

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

    def _policy_feats(self, pos, drink_sat, food_sat, safety, safety2,
                      obs_dir):
        """Per-agent [1, B] policy-feature rows, observed at the start of
        the step after the auto-reset: normalised row and column, drink and
        food satiation / 10, water and predator safety / 10, and the
        observation-direction one-hot."""
        tenth = _f32(0.1)
        feats = []
        for j in range(self.n):
            pos_f, onehot = self._pos_dir_feats(pos, obs_dir, j)
            feats.append(pos_f + [
                drink_sat[j : j + 1] * tenth,
                food_sat[j : j + 1] * tenth,
                safety[j : j + 1].to(_F32) * tenth,
                safety2[j : j + 1].to(_F32) * tenth,
            ] + onehot)
        return feats

    def feats_of(self, S):
        return self._policy_feats(
            S["pos"], S["drink_sat"], S["food_sat"], S["safety"],
            S["safety2"], S["obs_dir"],
        )

    def _redraw_layout(self, key_hi, key_lo, ctr0, c):
        """One fresh uniformly shuffled map per lane from the PRF: one word
        per interior cell gives distinct integer scores, and the T tiles of
        ``_placement_spec`` take the T smallest cells in order. Returns the
        rebuilt wall board, the code/distance board, the agent starts, the
        predator curtain and (sustainability) the resource curtains."""
        n, W, HW = self.n, self.w, self.HW
        ib = self._idx_bits
        iota = torch.arange(HW, dtype=torch.int64, device=key_hi.device).view(HW, 1)
        bits = prng._hash64(key_hi, key_lo, ctr0 + self.redraw_site, iota)
        base = (((bits >> (ib + 3)) << ib) | iota).to(_I32)
        masked = torch.where(c["interior"] > 0.5, base, SENT)
        shape = masked.shape
        idx_mask = (1 << ib) - 1
        code = torch.zeros(shape, dtype=_F32, device=base.device)
        wall_new = c["border_wall"].expand(shape)
        pred_new = torch.zeros_like(code)
        res_names = (
            {spec["name"] for spec in self.res_specs} if self.sustain else set()
        )
        res_new = {name: torch.zeros_like(code) for name in res_names}
        pos_rows = [None] * n
        dist = None  # min-Manhattan distance to the drawn water tiles
        for kind, info in self._placement_spec:
            minv = masked.min(dim=0, keepdim=True).values  # [1, B]
            picked = masked == minv  # one cell: the scores are distinct
            masked = torch.where(picked, SENT, masked)
            pf = picked.to(_F32)
            if kind == "agent":
                pos_rows[info] = minv & idx_mask
            elif kind == "predator":
                pred_new = pred_new + pf
            elif kind == "wall":
                wall_new = wall_new + pf
            elif kind == "water":
                code = code + float(TILE_CODES["water"]) * pf
                flat = minv & idx_mask
                d = ((c["cell_row"] - flat // W).abs()
                     + (c["cell_col"] - flat % W).abs())
                dist = d if dist is None else torch.minimum(dist, d)
            elif kind in res_names:
                res_new[kind] = res_new[kind] + pf
            else:  # gold, silver and the static resource codes
                code = code + float(TILE_CODES[kind]) * pf
        if dist is None:
            dist_f = 16.0 * 99.0
        else:
            dist_f = 16.0 * torch.where(dist > 98, 99, dist).to(_F32)
        return {
            "wall": wall_new,
            "sboard": code + dist_f,
            "pos0": torch.cat(pos_rows, dim=0),
            "predator0": pred_new,
            "res": res_new,
        }

    def _step(self, S: dict, statics=None, collect_draws: bool = False):
        """One full MA step on packed tensors: the plain version of K8 and
        K9. ``statics`` holds the policy (``pol_*`` or ``mlp_*`` tensors)
        and may hold the layouts (a lane shard's); ``None`` reads the policy
        installed by ``set_policies``."""
        env, cfg = self.env, self.cfg
        n, D, HW, W = self.n, self.D, self.HW, self.w
        dev = S["t"].device
        c = self._tables(dev, statics)
        if statics is None:
            statics = self._all_statics(dev)
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        iota_n = torch.arange(n, dtype=_I32, device=dev).view(n, 1)
        iota_hw = torch.arange(HW, dtype=torch.int64, device=dev).view(HW, 1)
        res_names = (
            tuple(spec["name"] for spec in self.res_specs) if self.sustain
            else ()
        )

        # ---- auto-reset lanes whose episode ended last step
        types = S["step_types"]
        over = ((types == LAST) | (types == DEAD)).all(dim=0, keepdim=True)
        ctr0 = (S["draw_ctr"].to(torch.int64) * self.n_sites) & 0xFFFF_FFFF
        ep_idx = None
        if self.exact_reset:
            # The per-episode redraw; like JAX's lax.cond, skipped on steps
            # where no lane resets (the PRF is stateless).
            wall_f, sboard = S["wall"], S["sboard"]
            pos, predator_f = S["pos"], S["predator"]
            res = {nm: S["res_" + nm] for nm in res_names}
            if bool(over.any()):
                fresh = self._redraw_layout(key_hi, key_lo, ctr0, c)
                wall_f = torch.where(over, fresh["wall"], wall_f)
                sboard = torch.where(over, fresh["sboard"], sboard)
                pos = torch.where(over, fresh["pos0"], pos)
                predator_f = torch.where(over, fresh["predator0"], predator_f)
                res = {nm: torch.where(over, fresh["res"][nm], res[nm])
                       for nm in res_names}

            def pooled(base_key):  # only usable_half stays static
                return c[base_key]
        else:
            # Layout pool: the lane's layout for this episode (ep_idx % K).
            pooled, ep_idx = self._pool_select(c, over, S)
            wall_f = pooled("wall")
            sboard = pooled("sboard")
            pos = torch.where(over, pooled("pos0"), S["pos"])
            predator_f = torch.where(over, pooled("predator0"), S["predator"])
            res = {nm: torch.where(over, pooled("res0_" + nm), S["res_" + nm])
                   for nm in res_names}
        predator = predator_f > 0.5
        reasons = torch.where(over, NONE, S["reasons"])
        types = torch.where(over, FIRST, types)
        act_dir = torch.where(over, UP_DIR, S["act_dir"])
        obs_dir = torch.where(over, UP_DIR, S["obs_dir"])
        step_count = torch.where(over, 0, S["step_count"])
        drink_sat = torch.where(over, _f32(self.sat0["drink"]), S["drink_sat"])
        food_sat = torch.where(over, _f32(self.sat0["food"]), S["food_sat"])
        visits = torch.where(over, 0, S["visits"])
        safety = torch.where(over, 3, S["safety"])
        safety2 = torch.where(over, 3, S["safety2"])
        t = torch.where(over, 0, S["t"])
        avail = {}
        for spec in self.res_specs if self.sustain else ():
            avail[spec["name"]] = torch.where(
                over, _f32(spec["amount"]), S["avail_" + spec["name"]]
            )

        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(
                pos, drink_sat, food_sat, safety, safety2, obs_dir
            )
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = torch.zeros((n * D, actions.shape[1]), dtype=_F32, device=dev)
        row_agent = c["row_agent"]
        vrow_agent, vrow_col = c["vrow_agent"], c["vrow_col"]
        cell_row, cell_col = c["cell_row"], c["cell_col"]
        rv = {
            k: (c["rv_" + k] if v is not None else None)
            for k, v in self.rv.items()
        }
        regrow_gap = torch.full_like(t, float("inf"), dtype=_F32)
        draws = []

        def addr(rewards, key_, sel_nd, cond_f):
            if rv[key_] is None:
                return rewards
            return rewards + rv[key_] * sel_nd * cond_f

        def rel(action_ids, dir_ids):
            out = torch.zeros_like(dir_ids)
            for d in range(4):
                row = _lut_select(REL_MOVE_DIR[:, d], action_ids, 0, 10)
                out = torch.where(dir_ids == d, row, out)
            return out

        for slot in range(n):
            i = order[slot : slot + 1]  # [1, B] acting agent index
            il = i.long()
            a = actions.gather(0, il)
            acting = a >= 0
            sel = iota_n == i
            sel_f = sel.to(_F32)
            sel_nd = (row_agent == i.to(_F32)).to(_F32)
            is_quit = a == QUIT
            is_noop = a == NOOP
            dead_i = reasons.gather(0, il) != NONE
            active = acting & ~is_quit & ~dead_i
            activef = active.to(_F32)
            t = t + acting.to(_I32)

            # --- relative direction updates
            dir_i = act_dir.gather(0, il)
            odir_i = obs_dir.gather(0, il)
            a_cl = a.clamp(0, 9)
            new_odir = rel(a_cl, odir_i)
            obs_dir = torch.where(sel & active, new_odir, obs_dir)
            new_adir = rel(a_cl, dir_i)
            abs_action = torch.where(
                is_noop, a, _lut_select(DIR_TO_ACTION_MO, new_adir, 0, 4)
            )
            # --- the move: the all-wall border keeps it in bounds; every
            # agent's cell blocks, dead or not
            flat_delta = torch.zeros_like(a)
            for aid in range(ACTION_DELTAS_MO.shape[0]):
                d = int(ACTION_DELTAS_MO[aid, 0] * W + ACTION_DELTAS_MO[aid, 1])
                if d:
                    flat_delta = torch.where(abs_action == aid, d, flat_delta)
            pos_i = pos.gather(0, il)
            cand = (pos_i + flat_delta).clamp(0, HW - 1)
            occ = ((pos == cand) & ~sel).any(dim=0, keepdim=True)
            wall_at = _read(wall_f, cand) > 0.5
            moved = active & ~is_noop & ~wall_at & ~occ
            new_pos_i = torch.where(moved, cand, pos_i)
            pos = torch.where(sel, new_pos_i, pos)
            act_dir = torch.where(sel & active, new_adir, act_dir)
            # A dead agent's QUIT does not count.
            step_count = step_count + (
                sel & (active | (is_quit & ~dead_i))
            ).to(_I32)
            reasons = torch.where(sel & is_quit & ~dead_i, QUIT_R, reasons)
            rewards = addr(rewards, "MOVEMENT_SCORE", sel_nd,
                           (active & ~is_noop).to(_F32))

            # --- decode the combined board at the new position
            v_at = _read(sboard, new_pos_i)
            dw_at = torch.floor(v_at * _f32(1.0 / 16.0))
            code_at = v_at - 16.0 * dw_at
            pred_at = _read(predator_f, new_pos_i) > 0.5
            on_res = {nm: _read(cur, new_pos_i) > 0.5 for nm, cur in res.items()}

            # --- satiation decrements and thirst/hunger death
            sat_sel = sel_f * activef
            if env._drink_flags_on and cfg["penalise_oversatiation"]:
                drink_sat = drink_sat + sat_sel * _f32(
                    cfg["DRINK_DEFICIENCY_RATE"])
            if env._food_flags_on and cfg["penalise_oversatiation"]:
                food_sat = food_sat + sat_sel * _f32(cfg["FOOD_DEFICIENCY_RATE"])
            if cfg["thirst_hunger_death"]:
                dsat_i = drink_sat.gather(0, il)
                fsat_i = food_sat.gather(0, il)
                dying = active & (
                    (dsat_i <= _f32(cfg["DRINK_DEFICIENCY_LIMIT"]))
                    | (fsat_i <= _f32(cfg["FOOD_DEFICIENCY_LIMIT"]))
                )
                rewards = addr(rewards, "THIRST_HUNGER_DEATH_SCORE", sel_nd,
                               dying.to(_F32))
                reasons = torch.where(
                    sel & dying & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- resource consumption
            def consume(rewards, visits, sat, ckey, score_key, coop_key,
                        rate, limit, visit_col, enabled, gate):
                if not enabled:
                    return rewards, visits, sat, torch.zeros_like(active)
                raw = (on_res[ckey] if self.sustain
                       else code_at == float(TILE_CODES[ckey]))
                on_tile = raw & active & gate
                onf = on_tile.to(_F32)
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == visit_col)
                ).to(_I32) * on_tile.to(_I32)
                if self.sustain:
                    av = avail[ckey]
                    got = on_tile & (av > 0.0)
                    gotf = got.to(_F32)
                    rewards = addr(rewards, score_key, sel_nd, gotf)
                    if cfg["penalise_oversatiation"]:
                        sat = sat + sel_f * gotf * av.clamp(max=_f32(rate))
                    if limit >= 0:
                        sat_i = sat.gather(0, il)
                        clamp = got & (sat_i > 0)
                        sat = torch.where(sel & clamp,
                                          sat.clamp(max=_f32(limit)), sat)
                    avail[ckey] = torch.where(
                        got, (av - _f32(rate)).clamp(min=0.0), av)
                else:
                    # The availability is the amount flag, always > 0.
                    rewards = addr(rewards, score_key, sel_nd, onf)
                    amount = float(self._amount_for(ckey))
                    if cfg["penalise_oversatiation"]:
                        sat = sat + sel_f * onf * _f32(min(amount, rate))
                    if limit >= 0:
                        sat_i = sat.gather(0, il)
                        clamp = on_tile & (sat_i > 0)
                        sat = torch.where(sel & clamp,
                                          sat.clamp(max=_f32(limit)), sat)
                if coop_key is not None and rv[coop_key] is not None:
                    rewards = rewards + rv[coop_key] * (1.0 - sel_nd) * onf
                return rewards, visits, sat, on_tile

            coop = "COOPERATION_SCORE" if n > 1 else None
            scoop = "SMALL_COOPERATION_SCORE" if n > 1 else None
            always = torch.ones_like(active)
            rewards, visits, drink_sat, on_drink = consume(
                rewards, visits, drink_sat, "drink", "DRINK_SCORE", coop,
                float(cfg["DRINK_EXTRACTION_RATE"]),
                float(cfg["DRINK_OVERSATIATION_LIMIT"]), 1, env._has_drink,
                always,
            )
            rewards, visits, drink_sat, on_sdrink = consume(
                rewards, visits, drink_sat, "small_drink", "SMALL_DRINK_SCORE",
                scoop, float(cfg["SMALL_DRINK_EXTRACTION_RATE"]),
                float(cfg["DRINK_OVERSATIATION_LIMIT"]), 3,
                env._has_small_drink, ~on_drink,
            )
            rewards, visits, food_sat, on_food = consume(
                rewards, visits, food_sat, "food", "FOOD_SCORE", coop,
                float(cfg["FOOD_EXTRACTION_RATE"]),
                float(cfg["FOOD_OVERSATIATION_LIMIT"]), 2, env._has_food,
                always,
            )
            rewards, visits, food_sat, on_sfood = consume(
                rewards, visits, food_sat, "small_food", "SMALL_FOOD_SCORE",
                scoop, float(cfg["SMALL_FOOD_EXTRACTION_RATE"]),
                float(cfg["FOOD_OVERSATIATION_LIMIT"]), 4,
                env._has_small_food, ~on_food,
            )
            rewards = addr(rewards, "NON_DRINK_SCORE", sel_nd,
                           (active & ~on_drink & ~on_sdrink).to(_F32))
            rewards = addr(rewards, "NON_FOOD_SCORE", sel_nd,
                           (active & ~on_food & ~on_sfood).to(_F32))

            # --- gold and silver log-scaled rewards
            for tkey, score_key, col, base_key, on in (
                ("gold", "GOLD_SCORE", 5, "GOLD_VISITS_LOG_BASE",
                 env._has_gold),
                ("silver", "SILVER_SCORE", 6, "SILVER_VISITS_LOG_BASE",
                 env._has_silver),
            ):
                if not on:
                    continue
                on_it = (code_at == float(TILE_CODES[tkey])) & active
                vrow = il * 7 + col
                prevv = visits.gather(0, vrow).to(_F32)
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == col)
                ).to(_I32) * on_it.to(_I32)
                if rv[score_key] is not None:
                    # A true division: PyTorch on the card turns a division
                    # by a host scalar into a product with its reciprocal.
                    log_base = torch.full_like(prevv, _f32(np.log(float(cfg[base_key]))))
                    factor = (
                        torch.log(prevv + 2.0) - torch.log(prevv + 1.0)
                    ) / log_base
                    rewards = rewards + (
                        rv[score_key] * sel_nd * factor * on_it.to(_F32)
                    )

            # --- gap visit
            others = ((pos == new_pos_i) & ~sel).any(dim=0, keepdim=True)
            on_gap = (code_at == 0.0) & ~pred_at & ~others & active
            for raw in on_res.values():
                on_gap = on_gap & ~raw  # curtain cells read code 0
            visits = visits + (
                (vrow_agent == i) & (vrow_col == 0)
            ).to(_I32) * on_gap.to(_I32)
            rewards = addr(rewards, "GAP_SCORE", sel_nd, on_gap.to(_F32))

            # --- homeostasis thresholds
            def homeo(rewards, sat, dkey, okey, enabled):
                if not enabled:
                    return rewards
                sat_i = sat.gather(0, il)
                deficient = (sat_i < _f32(cfg[dkey + "_THRESHOLD"])) & active
                proportional = cfg["use_satiation_proportional_reward"]
                if proportional:
                    if rv[dkey + "_SCORE"] is not None:
                        rewards = rewards + (
                            rv[dkey + "_SCORE"] * sel_nd
                            * torch.where(deficient, -sat_i, 0.0)
                        )
                else:
                    rewards = addr(rewards, dkey + "_SCORE", sel_nd,
                                   deficient.to(_F32))
                if cfg["penalise_oversatiation"]:
                    overs = (
                        (sat_i > _f32(cfg[okey + "_THRESHOLD"]))
                        & ~deficient & active
                    )
                    if proportional:
                        if rv[okey + "_SCORE"] is not None:
                            rewards = rewards + (
                                rv[okey + "_SCORE"] * sel_nd
                                * torch.where(overs, sat_i, 0.0)
                            )
                    else:
                        rewards = addr(rewards, okey + "_SCORE", sel_nd,
                                       overs.to(_F32))
                return rewards

            rewards = homeo(rewards, drink_sat, "DRINK_DEFICIENCY",
                            "DRINK_OVERSATIATION", env._drink_flags_on)
            rewards = homeo(rewards, food_sat, "FOOD_DEFICIENCY",
                            "FOOD_OVERSATIATION", env._food_flags_on)

            # --- safety distances: water from the board, predators by a
            # per-cell minimum
            if env._has_water:
                safety = torch.where(sel & active, dw_at.to(_I32), safety)
            if env._has_predators:
                manh = ((cell_row - new_pos_i // W).abs()
                        + (cell_col - new_pos_i % W).abs())
                d = torch.where(predator, manh, 9999).min(
                    dim=0, keepdim=True).values
                d = torch.where(d > 98, 99, d).to(_I32)
                safety2 = torch.where(sel & active, d, safety2)

            # --- water penalty
            if env._has_water:
                on_water = (code_at == float(TILE_CODES["water"])) & active
                rewards = addr(rewards, "DANGER_TILE_SCORE", sel_nd,
                               on_water.to(_F32))

            # --- predators: one hash word per cell gives the move uniform
            # (top 24 bits) and the direction (low 2 bits); four passes
            # move all of a direction's movers at once, each from the
            # board as it stood before the pass
            slot_draws = {}
            slot_base = 2 + slot * self.sites_per_slot
            player_cells = torch.zeros((HW, a.shape[1]), dtype=torch.bool,
                                       device=dev)
            for j in range(n):
                player_cells = player_cells | (iota_hw == pos[j : j + 1])
            if env._has_predators:
                rewards = addr(rewards, "PREDATOR_NPC_SCORE", sel_nd,
                               (pred_at & active).to(_F32))
                alive = reasons == NONE
                cmax = torch.where(alive, step_count, -1).max(
                    dim=0, keepdim=True).values
                cmin = torch.where(alive, step_count, 2**30).min(
                    dim=0, keepdim=True).values
                is_last = (cmax == cmin) & (cmax > 0)
                bits = prng._hash64(key_hi, key_lo, ctr0 + slot_base, iota_hw)
                u_move = prng.uniform01(bits)
                move_mask = (
                    (u_move < _f32(self.pred_move_p)) & predator & is_last
                    & ~player_cells
                )
                dirs = 1 + (bits & 3)
                cur_f = self._predator_walk(predator_f, wall_f, move_mask, dirs)
                landed_on_me = (_read(cur_f, new_pos_i) > 0.5) & ~pred_at & active
                rewards = addr(rewards, "PREDATOR_NPC_SCORE", sel_nd,
                               landed_on_me.to(_F32))
                # Committed only where the agent acts.
                predator_f = torch.where(acting, cur_f, predator_f)
                predator = predator_f > 0.5
                slot_draws["predator_after"] = predator

            # --- resource drapes: regrowth, then without-replacement tile
            # removal or spawn to the ceiling of the availability
            if self.sustain:
                for r_idx, spec in enumerate(self.res_specs):
                    name = spec["name"]
                    cur_f, av = res[name], avail[name]
                    # Any agent on the curtain blocks the regrowth.
                    on_any = ((cur_f > 0.5) & player_cells).any(
                        dim=0, keepdim=True)
                    can_grow = (
                        (t > 0) & ~on_any & (av >= 1.0)
                        & (av < _f32(spec["cond_limit"]))
                    )
                    raw = torch.exp(
                        _f32(float(cfg["DRINK_REGROWTH_EXPONENT"]))
                        * torch.log(av + 1.0)
                    )
                    grown = raw.clamp(max=_f32(spec["growth_limit"]))
                    grown = torch.minimum(grown, pooled("usable_half"))
                    av_new = torch.where(can_grow, grown, av)
                    av_int = torch.ceil(av_new)
                    # Only an unclamped power can round across an integer.
                    near = torch.where(grown == raw,
                                       (raw - torch.round(raw)).abs(),
                                       float("inf"))
                    regrow_gap = torch.where(
                        can_grow & acting, torch.minimum(regrow_gap, near),
                        regrow_gap,
                    )
                    if not spec["use_metric"]:
                        bits = prng._hash64(
                            key_hi, key_lo, ctr0 + (slot_base + 1 + r_idx),
                            iota_hw)
                        base = (((bits >> 12) << 9) | iota_hw).to(_I32)
                        current = cur_f.sum(dim=0, keepdim=True)
                        need = (current - av_int).clamp(min=0.0)
                        grow = (av_int - current).clamp(min=0.0)
                        removing = need > 0.5
                        count = torch.where(removing, need, grow)
                        sign = torch.where(removing, -1.0, 1.0)
                        rem_scores = torch.where(
                            cur_f > 0.5,
                            base + torch.where(player_cells, OFF_PLAYER, 0),
                            SENT,
                        )
                        spawn_scores = torch.where(
                            (cur_f < 0.5) & (wall_f < 0.5) & ~player_cells,
                            base, SENT,
                        )
                        scores = torch.where(removing, rem_scores, spawn_scores)
                        thresh = torch.where(removing, SENT, OFF_PLAYER)
                        tau = self._drape_cutoff(
                            scores, thresh, count,
                            max(spec["k_rem"], spec["k_spawn"]))
                        cur_f = cur_f + torch.where(scores <= tau, sign, 0.0)
                    res[name] = torch.where(acting, cur_f, res[name])
                    avail[name] = torch.where(acting, av_new, avail[name])
                    slot_draws[name + "_after"] = res[name] > 0.5

            if collect_draws:
                draws.append(slot_draws)

        # ---- finalize
        types, done = self._finalize_types(t, reasons, types, over)
        out = {
            "pos": pos,
            "predator": predator_f,
            "reasons": reasons,
            "step_types": types,
            "act_dir": act_dir,
            "obs_dir": obs_dir,
            "step_count": step_count,
            "drink_sat": drink_sat,
            "food_sat": food_sat,
            "visits": visits,
            "safety": safety,
            "safety2": safety2,
            "t": t,
            "key": S["key"],
            "draw_ctr": ((S["draw_ctr"].to(torch.int64) + 1) & 0xFFFF_FFFF).to(
                torch.uint32
            ),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.to(_I32),
        }
        for name in res:
            out["res_" + name] = res[name]
            out["avail_" + name] = avail[name]
        if ep_idx is not None:
            out["ep_idx"] = ep_idx
        if self.exact_reset:
            out["wall"] = wall_f
            out["sboard"] = sboard
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": rewards,
                "over": over,
                "pol": pol,
                "regrow_gap": regrow_gap,
                "slots": draws,
            }
        return out

    def _predator_walk(self, predator_f, wall_f, move_mask, dirs):
        """The predators' random walk: four passes, one per direction, each
        moving all of its movers at once from the board as it stood before
        the pass; returns the new curtain."""
        cur_f = predator_f
        for d_id in range(1, 5):
            dr, dc = ACTION_DELTAS_MO[d_id]
            shift = int(dr * self.w + dc)
            movers = move_mask & (dirs == d_id) & (cur_f > 0.5)
            # The border walls absorb the roll's wrap-around.
            tgt_free = torch.roll(cur_f + wall_f, -shift, 0) < 0.5
            mf = (movers & tgt_free).to(_F32)
            cur_f = cur_f - mf + torch.roll(mf, shift, 0)
        return cur_f

    @staticmethod
    def _drape_cutoff(scores, thresh, count, k):
        """A drape's cutoff tau: the count-th smallest candidate score (or
        the last valid one) by a chain of k masked minima, -1 without one;
        the drape picks {score <= tau}."""
        tau = torch.full_like(thresh, -1)
        masked = scores
        for _ in range(k):
            minv = masked.min(dim=0, keepdim=True).values
            valid = (minv < thresh) & (count > 0.5)
            tau = torch.where(valid, minv, tau)
            masked = torch.where(masked == minv, SENT, masked)
            count = count - valid.to(_F32)
        return tau

    # ------------------------------------------------------------- interop

    def lane_prf_ctx(self, S, lane: int, slot: int) -> dict:
        """One lane's counter-based PRF context for sub-step ``slot`` of the
        step taken from ``S``, in the ``options`` format of the generic
        ``engine_substep`` (``prf_key_hi``, ``prf_key_lo``,
        ``prf_site_base``; ``[1]`` int64 tensors holding uint32 words, a
        batch of one lane as ``unpack_lane``'s): its predator and drape
        draws then take the words this kernel draws there."""
        def word(x):
            return x.to(torch.int64).view(1) & 0xFFFF_FFFF

        ctr0 = word(S["draw_ctr"][0, lane]) * self.n_sites
        return {
            "prf_key_hi": word(S["key"][0, lane]),
            "prf_key_lo": word(S["key"][1, lane]),
            "prf_site_base": (ctr0 + 2 + slot * self.sites_per_slot)
            & 0xFFFF_FFFF,
        }

    def unpack_lane(self, S, lane: int):
        """The packed lane as the generic path's ``SavannaState``, a batch of
        one lane on ``S``'s device (key ``PRNGKey(0)``, as JAX's
        ``unpack_lane``). Under ``exact_reset`` the layout masks are decoded
        from the lane's ``sboard`` and ``wall``."""
        from ai_safety_gridworlds_torch.core import threefry
        from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
            SavannaState,
        )

        h, w, n = self.h, self.w, self.n
        dev = S["t"].device

        def col(name):
            return S[name][:, lane]

        def row(name):  # [n] -> [1, n]
            return col(name).view(1, n)

        st = self._statics_np
        if self.layout_pool > 1 and "ep_idx" in S:
            st = self._statics_np_pool[int(col("ep_idx")[0]) % self.layout_pool]
        masks = {k: torch.as_tensor(st[k][:, lane], device=dev) for k in (
            "wall", "water", "gold", "silver", "drink", "food", "small_drink",
            "small_food")}
        if self.exact_reset and "sboard" in S:
            code = col("sboard") % 16.0
            masks["wall"] = col("wall")
            for name, cid in TILE_CODES.items():
                if name not in ("gap", "wall"):
                    masks[name] = (code == float(cid)).to(_F32)

        def grid(v):
            return (v > 0.5).view(1, h, w)

        def curtain(name):
            if self.sustain and ("res_" + name) in S:
                return grid(col("res_" + name))
            return grid(masks[name])

        def avail_of(name, amount_flag):
            if self.sustain and ("avail_" + name) in S:
                return col("avail_" + name).to(_F32)
            return torch.full((1,), self.cfg[amount_flag], dtype=_F32,
                              device=dev)

        pos = col("pos").to(_I32)
        return SavannaState(
            t=col("t").to(_I32),
            key=threefry.PRNGKey(0, dev).view(1, 2),
            pos=torch.stack([pos // w, pos % w], dim=1).view(1, n, 2),
            step_types=row("step_types"),
            termination_reasons=row("reasons"),
            action_direction=row("act_dir"),
            observation_direction=row("obs_dir"),
            step_count=row("step_count"),
            wall=grid(masks["wall"]),
            water=grid(masks["water"]),
            gold=grid(masks["gold"]),
            silver=grid(masks["silver"]),
            drink_curtain=curtain("drink"),
            food_curtain=curtain("food"),
            small_drink_curtain=curtain("small_drink"),
            small_food_curtain=curtain("small_food"),
            predator_curtain=grid(col("predator")),
            drink_avail=avail_of("drink", "amount_drink_holes"),
            food_avail=avail_of("food", "amount_food_patches"),
            small_drink_avail=avail_of("small_drink",
                                       "amount_small_drink_holes"),
            small_food_avail=avail_of("small_food",
                                      "amount_small_food_patches"),
            drink_satiation=row("drink_sat"),
            food_satiation=row("food_sat"),
            visits=col("visits").view(1, n, 7),
            safety=row("safety"),
            safety2=row("safety2"),
        )

    # ----------------------------------------------------------- CUDA path

    def _rollout_kernel(self, S, n_steps, tile, statics=None):
        return fused_savanna_rollout(self, S, n_steps, tile, statics)

    def _collect_kernel(self, S, params, n_steps, tile, statics=None):
        return fused_savanna_collect(self, S, params, n_steps, tile, statics)


# ------------------------------------------------------------ CUDA kernels

_MAX_N, _MAX_D, _MAX_A, _MAX_POOL, _MAX_T = 4, 12, 5, 8, 256
# The drapes' scores embed the cell in 9 bits: distinct for HW <= 512 only.
_MAX_DRAPE_HW = 512
# Shared memory a block may take on sm_90 (bytes).
_MAX_SMEM = 232448
# Warp schedulers of an H100 SXM (132 SMs, 4 each): the default of the pure
# chooser; the wrappers pass the card's own count.
_H100_SCHEDULERS = 4 * 132
# Threads per lane (the lane group, g) and lane groups per warp of K8/K9:
# None lets ``_lanes_per_group`` choose g and runs 32 // g groups a warp;
# chip_smoke.py's sweep and the card tests pin values.
_LANES_PER_GROUP = None
_LANES_PER_WARP = None
# Placement kinds of the redraw, as csrc/fused_savanna.cu numbers them; an
# agent j is 16 + j.
_SPEC_CODES = {
    "predator": 1, "water": 2, "gold": 3, "silver": 4, "drink": 5, "food": 6,
    "small_drink": 7, "small_food": 8, "wall": 9,
}
_SV_FIELDS = (
    "pos", "predator", "reasons", "step_types", "act_dir", "obs_dir",
    "step_count", "drink_sat", "food_sat", "visits", "safety", "safety2", "t",
    "key", "draw_ctr", "stats_rewards", "stats_episodes", "ep_idx", "wall",
    "sboard",
)


class _SvState(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _SV_FIELDS] + [
        ("res", ctypes.c_void_p * 4), ("avail", ctypes.c_void_p * 4),
    ]


class _SvTraj(ctypes.Structure):
    """K9's outputs: the trajectory records ``[T, rows, B]`` and boot."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("feats", "action", "logp", "value", "reward", "done",
                     "boot")
    ]


_SV_INTS = (
    "B", "n_steps", "D", "HW", "H", "W", "amin", "amax", "max_iterations",
    "pool", "randomize", "exact_reset", "sustain", "n_sites",
    "sites_per_slot", "redraw_site", "idx_bits", "T", "has_water",
    "has_predators", "has_gold", "has_silver", "drink_flags_on",
    "food_flags_on", "penalise", "proportional", "thirst_death",
)
_SV_FLOATS = (
    "sat0_drink", "sat0_food", "drink_def_rate", "food_def_rate",
    "drink_def_limit", "food_def_limit", "drink_def_thresh",
    "food_def_thresh", "drink_over_thresh", "food_over_thresh",
    "pred_move_p", "regrowth_exponent", "gold_log_base", "silver_log_base",
)
_SV_RES_INTS = ("res_on", "res_site", "res_metric", "res_k", "res_limit_on",
                "res_code", "res_visit_col", "res_kind", "res_coop_kind")
_SV_RES_FLOATS = ("res_rate", "res_growth", "res_cond", "res_amount",
                  "res_sat_amt", "res_limit")


class _SvParams(ctypes.Structure):
    """Mirror of ``SvParams`` in ``csrc/fused_savanna.cu``."""

    _fields_ = [
        ("inp", _SvState),
        ("out", _SvState),
        ("wall", ctypes.c_void_p * _MAX_POOL),
        ("sboard", ctypes.c_void_p * _MAX_POOL),
        ("pos0", ctypes.c_void_p * _MAX_POOL),
        ("predator0", ctypes.c_void_p * _MAX_POOL),
        ("res0", (ctypes.c_void_p * 4) * _MAX_POOL),
        ("usable_half", ctypes.c_void_p * _MAX_POOL),
        *[(k, ctypes.c_int) for k in _SV_INTS],
        *[(k, ctypes.c_float) for k in _SV_FLOATS],
        *[(k, ctypes.c_int * 4) for k in _SV_RES_INTS],
        *[(k, ctypes.c_float * 4) for k in _SV_RES_FLOATS],
        ("rv", (ctypes.c_float * _MAX_D) * len(REWARD_KINDS)),
        ("rv_on", ctypes.c_int * len(REWARD_KINDS)),
        ("rel_dir", (ctypes.c_int * 4) * 10),
        ("dir_to_action", ctypes.c_int * 4),
        ("delta", ctypes.c_int * 10),
        ("spec", ctypes.c_ubyte * _MAX_T),
        *[(k, ctypes.c_float) for k in ("inv_w", "inv_hm1", "inv_wm1")],
        ("pol_w", ctypes.c_void_p),
        ("pol_b", ctypes.c_void_p),
        ("pol_eps", ctypes.c_void_p),
        ("pol_lanes", ctypes.c_int),
        *[(k, ctypes.c_void_p) for k in MLP_KEYS],
        ("hidden", ctypes.c_int),
        ("group", ctypes.c_int),
        ("lanes_per_warp", ctypes.c_int),
        ("traj", _SvTraj),
    ]


@functools.cache
def _savanna_lib():
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _cuda.load("fused_savanna")
    for entry in (lib.fused_savanna_rollout, lib.fused_savanna_collect):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    lib.sv_params_size.restype = ctypes.c_int
    lib.sv_lane_bytes.argtypes = [ctypes.c_void_p]
    lib.sv_lane_bytes.restype = ctypes.c_int
    if lib.sv_params_size() != ctypes.sizeof(_SvParams):
        raise RuntimeError(
            "SvParams layout differs between fused_savanna.cu "
            f"({lib.sv_params_size()} bytes) and Python "
            f"({ctypes.sizeof(_SvParams)} bytes)"
        )
    return lib


def _static_params(fused: FusedSavanna, tables: dict) -> _SvParams:
    """The static parameter block: the layout statics' device pointers (from
    ``tables``, the device cache or a lane shard's statics, which keeps them
    alive), the flags, the float32 constants, the per-resource constants,
    the reward vectors, the direction and move tables, the redraw's
    placement kinds and the features' reciprocals. The state, policy, MLP and trajectory pointers,
    B, n_steps and hidden are left at 0."""
    env, cfg = fused.env, fused.cfg
    K = fused.layout_pool
    p = _SvParams()
    for k in range(K):
        sfx = f"_p{k}" if k else ""
        for name in ("wall", "sboard", "pos0", "predator0", "usable_half"):
            if name + sfx in tables:
                getattr(p, name)[k] = tables[name + sfx].data_ptr()
        for r, res in enumerate(RESOURCES):
            if "res0_" + res + sfx in tables:
                p.res0[k][r] = tables["res0_" + res + sfx].data_ptr()
    spec_codes = [
        16 + info if kind == "agent" else _SPEC_CODES[kind]
        for kind, info in fused._placement_spec
    ] if fused.exact_reset else []
    ints = dict(
        D=fused.D, HW=fused.HW, H=fused.h, W=fused.w, amin=fused.amin,
        amax=fused.amax, max_iterations=fused.max_iterations, pool=K,
        randomize=bool(env.randomize_agent_actions_order),
        exact_reset=fused.exact_reset, sustain=fused.sustain,
        n_sites=fused.n_sites, sites_per_slot=fused.sites_per_slot,
        redraw_site=fused.redraw_site, idx_bits=fused._idx_bits,
        T=len(spec_codes), has_water=env._has_water,
        has_predators=env._has_predators, has_gold=env._has_gold,
        has_silver=env._has_silver, drink_flags_on=env._drink_flags_on,
        food_flags_on=env._food_flags_on,
        penalise=cfg["penalise_oversatiation"],
        proportional=cfg["use_satiation_proportional_reward"],
        thirst_death=cfg["thirst_hunger_death"],
    )
    for k, v in ints.items():
        setattr(p, k, int(v))
    floats = dict(
        sat0_drink=fused.sat0["drink"], sat0_food=fused.sat0["food"],
        drink_def_rate=cfg["DRINK_DEFICIENCY_RATE"],
        food_def_rate=cfg["FOOD_DEFICIENCY_RATE"],
        drink_def_limit=cfg["DRINK_DEFICIENCY_LIMIT"],
        food_def_limit=cfg["FOOD_DEFICIENCY_LIMIT"],
        drink_def_thresh=cfg["DRINK_DEFICIENCY_THRESHOLD"],
        food_def_thresh=cfg["FOOD_DEFICIENCY_THRESHOLD"],
        drink_over_thresh=cfg["DRINK_OVERSATIATION_THRESHOLD"],
        food_over_thresh=cfg["FOOD_OVERSATIATION_THRESHOLD"],
        pred_move_p=fused.pred_move_p,
        # Faithful reference quirk: every resource regrows with the DRINK
        # exponent.
        regrowth_exponent=cfg["DRINK_REGROWTH_EXPONENT"],
        gold_log_base=np.log(float(cfg["GOLD_VISITS_LOG_BASE"])),
        silver_log_base=np.log(float(cfg["SILVER_VISITS_LOG_BASE"])),
    )
    for k in _SV_FLOATS:
        setattr(p, k, _f32(float(floats[k])))
    specs = {s["name"]: (idx, s) for idx, s in enumerate(fused.res_specs)}
    on = {"drink": env._has_drink, "food": env._has_food,
          "small_drink": env._has_small_drink,
          "small_food": env._has_small_food}
    for r, name in enumerate(RESOURCES):
        drinkish = "drink" in name
        limit = float(cfg["DRINK_OVERSATIATION_LIMIT" if drinkish
                          else "FOOD_OVERSATIATION_LIMIT"])
        rate = float(cfg[name.upper() + "_EXTRACTION_RATE"])
        score = name.upper() + "_SCORE"
        coop = "SMALL_COOPERATION_SCORE" if name.startswith("small") else (
            "COOPERATION_SCORE")
        p.res_on[r] = int(bool(on[name]))
        p.res_code[r] = TILE_CODES[name]
        p.res_visit_col[r] = {"drink": 1, "food": 2, "small_drink": 3,
                              "small_food": 4}[name]
        p.res_kind[r] = REWARD_KINDS.index(score)
        p.res_coop_kind[r] = REWARD_KINDS.index(coop) if fused.n > 1 else -1
        p.res_limit_on[r] = int(limit >= 0)
        p.res_limit[r] = _f32(limit)
        p.res_rate[r] = _f32(rate)
        p.res_sat_amt[r] = _f32(min(float(fused._amount_for(name)), rate))
        if name in specs:
            idx, s = specs[name]
            p.res_site[r] = idx
            p.res_metric[r] = int(s["use_metric"])
            p.res_k[r] = max(s["k_rem"], s["k_spawn"])
            p.res_growth[r] = _f32(s["growth_limit"])
            p.res_cond[r] = _f32(s["cond_limit"])
            p.res_amount[r] = _f32(s["amount"])
    for r, kind in enumerate(REWARD_KINDS):
        vec = fused.rv[kind]
        if vec is not None:
            p.rv_on[r] = 1
            for d in range(fused.D):
                p.rv[r][d] = float(vec[d, 0])
    for a in range(10):
        for d in range(4):
            p.rel_dir[a][d] = int(REL_MOVE_DIR[a, d])
        p.delta[a] = int(ACTION_DELTAS_MO[a, 0] * fused.w + ACTION_DELTAS_MO[a, 1])
    for d in range(4):
        p.dir_to_action[d] = int(DIR_TO_ACTION_MO[d])
    for k, code in enumerate(spec_codes):
        p.spec[k] = code
    # The features' reciprocals, rounded to float32 as the reference rounds
    # them (fused_base._pos_dir_feats).
    p.inv_w = _f32(1.0 / fused.w)
    p.inv_hm1 = _f32(1.0 / max(fused.h - 1, 1))
    p.inv_wm1 = _f32(1.0 / max(fused.w - 1, 1))
    return p


def check_static_limits(fused, tile=None) -> None:
    """Raise ``NotImplementedError`` for what K8 and K9 lack whatever the
    state: more than 4 agents, 12 reward dims or 5 actions, a layout pool
    of more than 8, more than 256 redraw tiles, tile spawning on more than
    512 cells, and boards that fit no block of ``tile`` threads even at 32
    threads a lane. ``init_packed`` calls it on a CUDA device, so that
    ``BatchedEnv(..., backend="auto")`` takes the generic path for such a
    configuration; the plain version runs all of them."""
    if not 1 <= fused.n <= _MAX_N:
        raise NotImplementedError(
            f"the savanna kernels take 1..{_MAX_N} agents, not {fused.n}"
        )
    if fused.D > _MAX_D or fused.amax - fused.amin + 1 > _MAX_A:
        raise NotImplementedError(
            f"the savanna kernels take at most {_MAX_D} reward dims and "
            f"{_MAX_A} actions"
        )
    if fused.layout_pool > _MAX_POOL:
        raise NotImplementedError(
            f"the savanna kernels take a layout pool of at most {_MAX_POOL}"
        )
    if fused.exact_reset and len(fused._placement_spec) > _MAX_T:
        raise NotImplementedError(
            f"the savanna kernels redraw at most {_MAX_T} tiles, not "
            f"{len(fused._placement_spec)}"
        )
    if fused.sustain and fused.HW > _MAX_DRAPE_HW and any(
        not s["use_metric"] for s in fused.res_specs
    ):
        raise NotImplementedError(
            "the savanna kernels spawn and remove tiles on at most "
            f"{_MAX_DRAPE_HW} cells (the drape scores hold the cell in 9 "
            f"bits), not {fused.HW}"
        )
    if _geometry(fused, 32, tile, 0)[2] > _MAX_SMEM:
        raise NotImplementedError(
            f"the savanna kernels' boards ({_lane_bytes(fused)} bytes a lane) "
            f"fit no block of {tile or 32} threads"
        )


def _check_supported(fused, B: int, tables=None) -> None:
    """The configurations K8 and K9 lack raise ``NotImplementedError``
    (``check_static_limits``), and layouts drawn for another batch than
    ``B`` ``ValueError``: by default the engine's batch, else the lanes of
    the layouts in ``tables`` (``FusedMaBase._launch_tables`` of the
    statics a caller passed, a lane shard's); the plain version runs all of
    them."""
    check_static_limits(fused)
    if fused.packed_batch is None:
        raise ValueError("call init_packed before launching the kernels")
    if tables is not None:
        fused._check_statics_batch(tables, B)
    elif fused.packed_batch != B:
        raise ValueError(
            f"the layouts were drawn for {fused.packed_batch} lanes, not the "
            f"batch {B}; init_packed drew them for another batch"
        )


def _drapes(fused) -> bool:
    """Whether a sustainability drape spawns and removes tiles."""
    return fused.sustain and any(not s["use_metric"] for s in fused.res_specs)


def _lane_bytes(fused) -> int:
    """Shared memory of one lane's boards in K8/K9, as ``sv_lane_words`` in
    ``csrc/fused_savanna.cu`` lays them out: a byte a cell for the predator
    curtain, the wall board and each sustainability curtain, two for the
    code/distance board (each rounded up to 4 bytes), a score word a cell
    with a tile-spawning drape, and an odd number of words in all."""
    hwp = -(-fused.HW // 4) * 4
    n_cur = len(fused.res_specs) if fused.sustain else 0
    nbytes = hwp * (2 + n_cur) + 2 * hwp + (4 * fused.HW if _drapes(fused) else 0)
    return 4 * ((nbytes // 4) | 1)


def _geometry(fused, g, tile, hidden):
    """``(lane groups a warp, threads, shared bytes)`` of a K8/K9 block of
    g-thread lane groups: 32 // g groups a warp (fewer where
    ``_LANES_PER_WARP`` pins them); ``tile`` threads, or by default a block
    of 32 lanes (at most 256 threads) halved while it does not fit; the
    MLP's weights (K9, ``hidden`` units) and the lanes' boards."""
    lanes = 32 // g if _LANES_PER_WARP is None else min(_LANES_PER_WARP, 32 // g)
    weights = _collect_smem_bytes(fused, hidden) if hidden else 0

    def smem(threads):
        return weights + threads // 32 * lanes * _lane_bytes(fused)

    threads = tile
    if threads is None:
        threads = min(256, 1024 // lanes)
        while threads > 32 and smem(threads) > _MAX_SMEM:
            threads //= 2
    return lanes, threads, smem(threads)


# (largest g, least g, warps a scheduler) of the lane group by the per-cell
# work of a sub-step (chip_smoke.py's group-size sweep on the H100, PERF.md):
# K8 with none, with predators (the walk and the safety distance) and with a
# tile-spawning drape; K9, whose MLP splits over the group too, without and
# with such work.
_GROUP_RANGE = {"light": (4, 2, 1), "predators": (16, 4, 4),
                "drapes": (16, 8, 4), "mlp_light": (8, 2, 4), "mlp": (16, 2, 4)}


def _lanes_per_group(fused, B: int, tile=None, hidden: int = 0,
                     schedulers: int = _H100_SCHEDULERS) -> int:
    """g, the threads of the lane group that runs each lane of K8 (or of K9
    with ``hidden`` MLP units), a power of two dividing 32, from the batch
    ``B`` and the configuration's per-cell work.

    A lane's steps are one dependent chain, which its group runs together:
    the per-cell passes (the drapes' hashes and picks, the predator walk and
    safety distance, the redraw) and K9's MLP split over the g threads, the
    scalar part runs on all of them. The largest g of the configuration's
    range (``_GROUP_RANGE``) whose ceil(B * g / 32) warps fit the range's
    count to each of the card's ``schedulers``, and at least the range's
    least g: more threads a lane shorten the chain while the card has room
    for the warps, fewer keep the redundant scalar part small once it has
    none. Then g doubles while a block of ``tile`` threads (``_geometry``)
    does not fit the shared memory. ``_LANES_PER_GROUP`` pins g."""
    g = _LANES_PER_GROUP
    if g is None:
        drapes = _drapes(fused)
        heavy = drapes or fused.env._has_predators
        if hidden:
            work = "mlp" if heavy else "mlp_light"
        else:
            work = "drapes" if drapes else "predators" if heavy else "light"
        top, least, per_scheduler = _GROUP_RANGE[work]
        g = next((k for k in (16, 8, 4, 2)
                  if k <= top and -(-B * k // 32) <= per_scheduler * schedulers),
                 1)
        g = max(g, least)
    while g < 32 and _geometry(fused, g, tile, hidden)[2] > _MAX_SMEM:
        g *= 2
    return g


def _block(fused, B, tile, hidden=0, schedulers=_H100_SCHEDULERS):
    """``(g, lane groups a warp, threads, shared bytes)`` of a K8/K9 launch
    at batch ``B``; raises ``ValueError`` when no lane group fits a block
    of ``tile`` threads."""
    g = _lanes_per_group(fused, B, tile, hidden, schedulers)
    lanes, threads, smem = _geometry(fused, g, tile, hidden)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the savanna kernels' boards ({_lane_bytes(fused)} bytes a lane) "
            f"do not fit a block of {threads} threads"
        )
    return g, lanes, threads, smem


def _check_launch(fused, S, n_steps, tile, hidden=0, tables=None):
    """The checks both kernels share; returns ``(device, B, n_steps,
    block)`` with ``block`` from ``_block``. Configurations the kernels lack
    raise ``NotImplementedError``, bad inputs ``ValueError``, both before any
    launch; ``tables`` as for ``_check_supported``."""
    device = S["t"].device
    if device.type != "cuda":
        raise NotImplementedError(f"no savanna kernel for {device}")
    _check_supported(fused, S["t"].shape[1], tables)
    B, n_steps = check_kernel_state(
        fused, S, n_steps, 32 if tile is None else tile,
        max(fused.HW, fused.n * fused.D, fused.n * 7),
    )
    from ai_safety_gridworlds_torch.ops.fused_scalar import _schedulers

    return device, B, n_steps, _block(fused, B, tile, hidden,
                                      _schedulers(str(device)))


def _params(fused, S, out, device, tables=None) -> _SvParams:
    """A copy of the static block cached in ``tables``
    (``FusedMaBase._launch_tables``; by default the device cache) with this
    call's state pointers."""
    if tables is None:
        tables = fused._on(device)
    if "_k8_params" not in tables:
        tables["_k8_params"] = _static_params(fused, tables)
    p = _SvParams.from_buffer_copy(tables["_k8_params"])
    for name in fused.STATE_FIELDS:
        if name.startswith(("res_", "avail_")):
            kind, res = name.split("_", 1)
            r = RESOURCES.index(res)
            getattr(p.inp, kind)[r] = S[name].data_ptr()
            getattr(p.out, kind)[r] = out[name].data_ptr()
        else:
            setattr(p.inp, name, S[name].data_ptr())
            setattr(p.out, name, out[name].data_ptr())
    p.B = S["t"].shape[1]
    return p


def fused_savanna_rollout(fused: FusedSavanna, S: dict, n_steps: int,
                          tile=FusedSavanna.DEFAULT_TILE, statics=None) -> dict:
    """Advance a packed CUDA state ``n_steps`` steps with one launch of K8
    (``csrc/fused_savanna.cu``); returns a new state dict. The policy
    installed by ``set_policies`` at the time of the call picks the actions
    (K8's linear branch); without one the draws are uniform.

    ``tile`` is the threads per block (a multiple of 32 in [32, 256]);
    each lane runs on a group of ``_lanes_per_group`` threads, so a block
    holds ``tile // g`` lanes. None sizes a block of 32 lanes. ``statics``
    (the layouts and the policy) as for :meth:`FusedMaBase.rollout`.

    Checks every field's device, dtype, shape and contiguity and raises on
    what the kernel does not take; CPU tensors take the plain version."""
    if S["t"].device.type == "cpu":
        return fused.rollout_plain(S, n_steps, statics)
    tables = fused._launch_tables(S["t"].device, statics)
    device, B, n_steps, block = _check_launch(
        fused, S, n_steps, tile, tables=None if statics is None else tables)
    if statics is None:
        statics = fused._all_statics(device)
    fused._check_statics_batch(statics, B)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    if n_steps == 0:
        for k in out:
            out[k].copy_(S[k])
        return out
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _savanna_lib()
    p = _params(fused, S, out, device, tables)
    if "pol_w" in statics:
        for k in POLICY_KEYS:
            setattr(p, k, statics[k].data_ptr())
        p.pol_lanes = statics["pol_w"].shape[1]
    p.n_steps = n_steps
    p.group, p.lanes_per_warp, threads, _ = block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_savanna_rollout(ctypes.byref(p), fused.n, threads,
                                        stream)
    fused_savanna_rollout.launches += 1
    _cuda.check(lib, err, "fused_savanna_rollout launch")
    return out


fused_savanna_rollout.launches = 0


def _collect_smem_bytes(fused: FusedSavanna, hidden: int) -> int:
    """K9's shared memory per block: the MLP's weights as float32."""
    A = fused.amax - fused.amin + 1
    return 4 * (hidden * fused.POLICY_FEATURES + hidden + (A + 1) * (hidden + 1))


def fused_savanna_collect(fused: FusedSavanna, S: dict, params: dict,
                          n_steps: int, tile=FusedSavanna.DEFAULT_TILE,
                          statics=None):
    """The PPO collection: ``n_steps`` steps under the MLP policy ``params``
    with one launch of K9 (``csrc/fused_savanna.cu``); ``tile`` as for
    :func:`fused_savanna_rollout`.

    Returns ``(S, traj, boot)`` as :meth:`FusedMaBase.rollout_collect`:
    ``traj[name]`` is ``[n_steps, rows, B]``, ``boot`` is ``[n, B]``. Checks
    the state as K8 does and each MLP tensor's device, dtype, shape and
    contiguity; CPU tensors take the plain version. ``statics`` (K9 reads
    their layouts) as for :meth:`FusedMaBase.rollout`."""
    if S["t"].device.type == "cpu":
        return fused.rollout_collect_plain(S, params, n_steps, statics)
    if S["t"].device.type != "cuda":
        raise NotImplementedError(f"no savanna kernel for {S['t'].device}")
    H = check_mlp_params(fused, params, S["t"].device)
    if _collect_smem_bytes(fused, H) > _MAX_SMEM:
        raise ValueError(f"hidden {H} does not fit K9's shared memory")
    tables = fused._launch_tables(S["t"].device, statics)
    device, B, n_steps, block = _check_launch(
        fused, S, n_steps, tile, H, None if statics is None else tables)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    traj = {
        name: torch.empty((n_steps, rows, B), dtype=dtype, device=device)
        for name, rows, dtype in fused._traj_layout()
    }
    boot = torch.empty((fused.n, B), dtype=_F32, device=device)
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _savanna_lib()
    p = _params(fused, S, out, device, tables)
    for k in MLP_KEYS:
        setattr(p, k, params[k].data_ptr())
    for name in traj:
        setattr(p.traj, name, traj[name].data_ptr())
    p.traj.boot = boot.data_ptr()
    p.n_steps, p.hidden = n_steps, H
    p.group, p.lanes_per_warp, threads, _ = block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_savanna_collect(ctypes.byref(p), fused.n, threads,
                                        stream)
    fused_savanna_collect.launches += 1
    _cuda.check(lib, err, "fused_savanna_collect launch")
    return out, traj, boot


fused_savanna_collect.launches = 0
