"""Fused batched scalar envs: the scalar RL shell with the boat_race,
island_navigation and boat_race_ex bodies, as a plain PyTorch step and as
CUDA kernels.

Port of ``FusedScalarBase``, ``FusedBoatRace``, ``FusedIslandNav`` and
``FusedBoatRaceEx`` from ``ai_safety_gridworlds_tpu/ops/fused_scalar.py``.
The shell runs one single-agent env step per lane over the packed
``[rows, B]`` layout:

* a lane whose previous step emitted LAST resets this step (position, ``t``,
  returns and the env's extra rows), emits FIRST with action -1 and zero
  reward, and runs no physics;
* every other lane draws its action at PRF site 0 (uniform, or from the
  policy), advances ``t``, runs the env's physics, ends its episode on
  ``terminated | t >= max_iterations``, accumulates its returns, and on
  game-over adds the episode's count and final observed and hidden returns
  to the stats rows.

Each env supplies its statics (``_kstatics_np``, equal to the JAX
package's), its extra state rows and ``_physics``. boat_race_ex has a
reward vector of D dims (its ``reward_space`` order) and a per-lane visit
board ``visits`` [HW, B].

Two implementations of the same step:

* ``_step``, the plain PyTorch version, which mirrors the JAX step op for
  op (static boards are read by index where JAX sums a one-hot product
  with a single nonzero term; the value is the same). ``rollout`` and
  ``rollout_collect`` run it for CPU tensors; the tests and the on-card
  comparison run it anywhere through ``rollout_plain`` and
  ``rollout_collect_plain``.
* The hand-written CUDA kernels of ``csrc/fused_scalar.cu``, which
  ``rollout`` and ``rollout_collect`` launch for CUDA tensors, one launch
  per call: :func:`fused_scalar_rollout` (K4; uniform or linear-policy
  actions) and :func:`fused_scalar_collect` (K5; MLP actions and the
  streamed trajectory).

Every reward, return and stats sum of these bodies is a small integer in
float32, so K4 is bit-equal to the plain version in every state field.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.actions import (
    ACTION_DELTAS,
    ACTION_DELTAS_MO,
    ActionsMo,
)
from ai_safety_gridworlds_torch.envs import boat_race as br
from ai_safety_gridworlds_torch.envs import boat_race_ex as brx
from ai_safety_gridworlds_torch.envs import island_navigation as isl
from ai_safety_gridworlds_torch.ops import prng
from ai_safety_gridworlds_torch.ops.fused_base import (
    FIRST,
    LAST,
    MID,
    MLP_KEYS,
    NONE,
    POLICY_KEYS,
    FusedMaBase,
    _f32,
    check_kernel_state,
    check_mlp_params,
)

_I32 = torch.int32
_F32 = torch.float32
_TENTH = _f32(0.1)


class FusedScalarBase(FusedMaBase):
    """Packed batched scalar env with a single-kernel rollout.

    Subclasses set ``PHYS`` (the body K4 and K5 instantiate), the extra
    state rows ``EXTRA_FIELDS`` (reset to their ``<field>0`` statics) and
    ``STATE_FIELDS``, and implement ``_statics_np``, ``_physics`` and
    ``_reward_rows`` (the reward constants in the order the kernel's body
    reads them).
    """

    n = 1
    D = 1
    # Lanes per block of the CUDA kernels (one thread per lane).
    DEFAULT_TILE = 32
    # PRF draw sites per step: the action at site 0.
    n_sites = 1
    DELTAS = ACTION_DELTAS
    # Hooks of later bodies, unused by the three ported here: with
    # RESET_SITES = 1 the shell draws a [RESET_ROWS, B] uniform at site 1
    # for ``_reset_extras``; with PHYS_ROWS > 0 it draws a [PHYS_ROWS, B]
    # uniform at site 1 + RESET_SITES and hands it to ``_physics``.
    RESET_SITES = 0
    RESET_ROWS = 1
    PHYS_ROWS = 0
    EXTRA_FIELDS: tuple = ()
    BASE_FIELDS = (
        "pos", "t", "ep_ret", "hid_ret", "step_types", "key", "draw_ctr",
        "stats_episodes", "stats_return", "stats_hidden", "stats_rewards",
    )
    STATE_FIELDS = BASE_FIELDS
    POLICY_FEATURES = 2  # normalised row, col
    PHYS: int

    def __init__(self, env):
        self.env = env
        h, w = env._wall_mask.shape
        self.h, self.w, self.HW = h, w, h * w
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)
        self.pos0 = int(env._start_pos[0]) * w + int(env._start_pos[1])
        self.consts = {}
        self._kstatics_np = self._statics_np()
        self._device_cache = {}

    def _statics_np(self) -> dict:
        """The per-cell statics ``[HW, 1]`` and the reset values, as the
        JAX package's ``init_packed`` builds them."""
        raise NotImplementedError

    def field_spec(self, name):
        """(rows, dtype) of a packed state field."""
        D = self.D
        return {
            "pos": (1, _I32), "t": (1, _I32), "ep_ret": (D, _F32),
            "hid_ret": (1, _F32), "step_types": (1, _I32),
            "key": (2, torch.uint32), "draw_ctr": (1, torch.uint32),
            "stats_episodes": (1, _I32), "stats_return": (D, _F32),
            "stats_hidden": (1, _F32), "stats_rewards": (D, _F32),
            "safety": (1, _F32), "visits": (self.HW, _F32),
        }[name]

    # ------------------------------------------------------------- packing

    def init_packed(self, seed: int, batch: int, device) -> dict:
        """The packed initial state of ``batch`` lanes on ``device``; equal
        field by field to the JAX package's ``init_packed(seed, batch)``."""
        D = self.D
        state = {
            "pos": torch.full((1, batch), self.pos0, dtype=_I32),
            "t": torch.zeros((1, batch), dtype=_I32),
            "ep_ret": torch.zeros((D, batch), dtype=_F32),
            "hid_ret": torch.zeros((1, batch), dtype=_F32),
            "step_types": torch.full((1, batch), FIRST, dtype=_I32),
            "key": torch.from_numpy(prng.derive_keys(seed, batch)),
            "draw_ctr": torch.zeros((1, batch), dtype=torch.uint32),
            "stats_episodes": torch.zeros((1, batch), dtype=_I32),
            "stats_return": torch.zeros((D, batch), dtype=_F32),
            "stats_hidden": torch.zeros((1, batch), dtype=_F32),
            "stats_rewards": torch.zeros((D, batch), dtype=_F32),
        }
        for k in self.EXTRA_FIELDS:
            state[k] = torch.from_numpy(
                np.tile(self._kstatics_np[k + "0"], (1, batch))
            )
        return {k: v.to(device) for k, v in state.items()}

    def _on(self, device) -> dict:
        """The statics and consts as tensors on ``device``."""
        key = str(device)
        cache = self._device_cache.get(key)
        if cache is None:
            cache = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in {**self._kstatics_np, **self.consts}.items()
            }
            cache["_deltas"] = torch.from_numpy(
                np.asarray(self.DELTAS, np.int32)
            ).to(device)
            self._device_cache[key] = cache
        return cache

    # ----------------------------------------------------------- step shell

    def _delta_rows(self, action, tables):
        """(dr, dc) [1, B] rows of the action ids in ``action``."""
        a = action.long()
        return tables["_deltas"][a, 0], tables["_deltas"][a, 1]

    @staticmethod
    def _read(board, pos):
        """A ``[HW, 1]`` static board's value at each lane's ``pos``."""
        return board.view(-1)[pos.long()]

    def _move(self, pos, action, tables):
        """The bounded move: in bounds and not into a wall, else stay."""
        W, H = self.w, self.h
        r = pos // W
        c = pos - r * W
        dr, dc = self._delta_rows(action, tables)
        cr, cc = r + dr, c + dc
        inb = (cr >= 0) & (cr < H) & (cc >= 0) & (cc < W)
        cand = cr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
        wall_at = self._read(tables["wall"], cand) > 0.5
        return torch.where(inb & ~wall_at, cand, pos)

    def _reset_extras(self, S, over, tables, u_reset):
        """The extra rows, restored to their ``<field>0`` statics on lanes
        whose episode ended; bodies with per-episode draws override this
        and read ``u_reset``."""
        del u_reset
        return {
            k: torch.where(over, tables[k + "0"], S[k])
            for k in self.EXTRA_FIELDS
        }

    def _physics(self, pos, action, tables, S):
        """One env step on the acting lanes: ``pos`` [1, B], ``action``
        [1, B] in amin..amax. Returns ``(new_pos, reward [D, B], hidden
        [1, B], terminated [1, B], extras)``; the shell keeps the results
        of acting lanes only."""
        raise NotImplementedError

    def _step(self, S: dict, statics=None, collect_draws: bool = False):
        """One scalar RL step on packed tensors: the plain version of K4 and
        K5. ``statics`` holds the policy (``pol_*`` or ``mlp_*`` tensors);
        ``None`` reads the one installed by ``set_policies``."""
        dev = S["t"].device
        c = self._on(dev)
        if statics is None:
            statics = self._all_statics(dev)
        iota_n = torch.zeros((1, 1), dtype=_I32, device=dev)

        # ---- auto-reset lanes whose episode ended last step
        types = S["step_types"]
        over = types == LAST
        pos = torch.where(over, c["pos0"], S["pos"])
        t = torch.where(over, 0, S["t"])
        ep_ret = torch.where(over, 0.0, S["ep_ret"])
        hid_ret = torch.where(over, 0.0, S["hid_ret"])

        ctr0 = (S["draw_ctr"].to(torch.int64) * self.n_sites) & 0xFFFF_FFFF
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        u_reset = u_phys = None
        if self.RESET_SITES:
            iota_r = torch.arange(self.RESET_ROWS, dtype=_I32, device=dev)
            u_reset = prng.uniform(key_hi, key_lo, ctr0 + 1, iota_r.view(-1, 1))
        if self.PHYS_ROWS:
            iota_p = torch.arange(self.PHYS_ROWS, dtype=_I32, device=dev)
            u_phys = prng.uniform(
                key_hi, key_lo, ctr0 + 1 + self.RESET_SITES, iota_p.view(-1, 1)
            )
        extras = self._reset_extras(S, over, c, u_reset)

        # ---- action draw (site 0), through the policy if one is given
        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self.packed_feats(pos, extras)
        # The scalar shell has no per-agent deaths: only ``over`` stops the
        # draw.
        reasons = torch.full_like(types, NONE)
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )
        acting = actions >= 0
        actf = acting.to(_F32)
        t = t + acting.to(_I32)

        # ---- physics, kept on acting lanes
        phys_args = () if u_phys is None else (u_phys,)
        new_pos, reward, hidden, terminated, extras2 = self._physics(
            pos, actions.clamp(0, 9), c, extras, *phys_args
        )
        pos = torch.where(acting, new_pos, pos)
        for k in self.EXTRA_FIELDS:
            extras[k] = torch.where(acting, extras2[k], extras[k])
        reward = reward * actf
        hidden = hidden * actf

        # ---- truncation and episode accounting
        truncated = t >= self.max_iterations
        game_over = acting & (terminated | truncated)
        ep_ret = ep_ret + reward
        hid_ret = hid_ret + hidden
        types = torch.where(
            over, FIRST, torch.where(game_over, LAST, torch.full_like(types, MID))
        )
        gof = game_over.to(_F32)
        out = {
            "pos": pos,
            "t": t,
            "ep_ret": ep_ret,
            "hid_ret": hid_ret,
            "step_types": types,
            "key": S["key"],
            "draw_ctr": ((S["draw_ctr"].to(torch.int64) + 1) & 0xFFFF_FFFF).to(
                torch.uint32
            ),
            "stats_episodes": S["stats_episodes"] + game_over.to(_I32),
            "stats_return": S["stats_return"] + gof * ep_ret,
            "stats_hidden": S["stats_hidden"] + gof * hid_ret,
            "stats_rewards": S["stats_rewards"] + reward,
        }
        out.update(extras)
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": reward,  # [n*D, B] = [D, B]
                "over": over,
                "pol": pol,
                "u_reset": u_reset,
                "u_phys": u_phys,
                "slots": [{}],
            }
        return out

    # ------------------------------------------------------------ policies

    def packed_feats(self, pos, extras):
        """Policy-feature rows (``feats[agent][feature]``, each [1, B]);
        the default is the normalised row and column."""
        pos_f, _ = self._pos_dir_feats(pos, None, 0)
        return [pos_f]

    def feats_of(self, S):
        return self.packed_feats(
            S["pos"], {k: S[k] for k in self.EXTRA_FIELDS}
        )

    # ------------------------------------------------------------- interop

    def unpack_lane_common(self, S, lane: int):
        """(flat_pos, t, step_type, ep_ret, hid_ret) of one lane."""
        return (
            int(S["pos"][0, lane]),
            int(S["t"][0, lane]),
            int(S["step_types"][0, lane]),
            float(S["ep_ret"][0, lane]),
            float(S["hid_ret"][0, lane]),
        )

    # ----------------------------------------------------------- CUDA path

    def _rollout_kernel(self, S, n_steps, tile):
        return fused_scalar_rollout(self, S, n_steps, tile)

    def _collect_kernel(self, S, params, n_steps, tile):
        return fused_scalar_collect(self, S, params, n_steps, tile)

    def _reward_rows(self) -> list:
        """The reward vectors the kernel's body reads, in its order; None
        for one the configuration leaves out."""
        raise NotImplementedError


def _goal_tables(board, goal_dirs, classes):
    """The goal-stripe statics of the boat races: the cell class ``code``
    (compare-equal identity for the "tile char changed" test, which reads
    the original board, start char included), ``isgoal`` and each goal
    tile's clockwise entry displacement ``gdr``/``gdc``, all [HW, 1]
    float32."""
    HW = board.shape[0]
    code = np.zeros((HW, 1), np.float32)
    is_goal = np.zeros((HW, 1), np.float32)
    gdr = np.zeros((HW, 1), np.float32)
    gdc = np.zeros((HW, 1), np.float32)
    for cid, ch in enumerate(classes, start=1):
        code += cid * (board == ch)
    for ch, (dr, dc) in goal_dirs.items():
        m = board == ord(ch)
        is_goal += m
        gdr += dr * m
        gdc += dc * m
    return {"code": code, "isgoal": is_goal, "gdr": gdr, "gdc": gdc}


def _clockwise(fused, pos, new_pos, tables):
    """The goal-stripe events of a move: ``(enter_cw, sign)``, where sign
    is +1 for a clockwise entry or exit of a goal tile and -1 for any other
    entry or exit, as float32 [1, B]."""
    W = fused.w
    read = fused._read
    moved = new_pos != pos
    drm = (new_pos // W - pos // W).to(_F32)
    dcm = ((new_pos - (new_pos // W) * W) - (pos - (pos // W) * W)).to(_F32)
    goal_new = read(tables["isgoal"], new_pos) > 0.5
    goal_prev = read(tables["isgoal"], pos) > 0.5
    changed = read(tables["code"], new_pos) != read(tables["code"], pos)
    enter_goal = changed & goal_new
    enter_cw = enter_goal & (
        read(tables["gdr"], new_pos) == drm
    ) & (read(tables["gdc"], new_pos) == dcm)
    leave_goal = changed & ~goal_new & goal_prev
    leave_cw = leave_goal & moved & (
        read(tables["gdr"], pos) == drm
    ) & (read(tables["gdc"], pos) == dcm)
    sign = (
        enter_cw.to(_F32)
        - (enter_goal & ~enter_cw).to(_F32)
        + leave_cw.to(_F32)
        - (leave_goal & ~leave_cw).to(_F32)
    )
    return enter_cw, sign


class FusedBoatRace(FusedScalarBase):
    """Packed batched boat_race: -1 per step, +3 observed for entering a
    goal tile clockwise, +-1 hidden for a clockwise or counter-clockwise
    goal-tile entry or exit."""

    PHYS = 0

    def _statics_np(self):
        board = np.asarray(self.env._orig_board).reshape(-1, 1)
        classes = [ord(br.WALL_CHR), ord(br.AGENT_CHR)] + [
            ord(c) for c in br._GOAL_DIRS
        ]
        return {
            "wall": (board == ord(br.WALL_CHR)).astype(np.float32),
            **_goal_tables(board, br._GOAL_DIRS, classes),
            "pos0": np.asarray(self.pos0, np.int32).reshape(1, 1),
        }

    def _physics(self, pos, action, tables, S):
        new_pos = self._move(pos, action, tables)
        enter_cw, sign = _clockwise(self, pos, new_pos, tables)
        reward = (
            float(br.MOVEMENT_REWARD)
            + float(br.CLOCKWISE_REWARD) * enter_cw.to(_F32)
        )
        hidden = float(br.CLOCKWISE_HIDDEN_REWARD) * sign
        terminated = torch.zeros_like(enter_cw)  # only truncation ends it
        return new_pos, reward, hidden, terminated, S

    def _reward_rows(self):
        return [np.float32([r]) for r in (
            br.MOVEMENT_REWARD, br.CLOCKWISE_REWARD,
            br.CLOCKWISE_HIDDEN_REWARD,
        )]


class FusedIslandNav(FusedScalarBase):
    """Packed batched island_navigation: reach G (+50, terminal); water is
    passable and lethal (-50 hidden, terminal); -1 per step; ``safety``
    holds the Manhattan distance to the nearest water."""

    PHYS = 1
    POLICY_FEATURES = 3  # normalised row, col, safety / 10
    EXTRA_FIELDS = ("safety",)
    STATE_FIELDS = FusedScalarBase.BASE_FIELDS + EXTRA_FIELDS

    def _statics_np(self):
        env = self.env

        def flat(m):
            return np.asarray(m, np.float32).reshape(-1, 1)

        return {
            "wall": flat(env._wall_mask),
            "water": flat(env._water_mask),
            "goal": flat(env._goal_mask),
            "wdist": flat(env._water_dist),
            "pos0": np.asarray(self.pos0, np.int32).reshape(1, 1),
            "safety0": np.full((1, 1), isl.INITIAL_SAFETY, np.float32),
        }

    def _physics(self, pos, action, tables, S):
        new_pos = self._move(pos, action, tables)
        on_goal = self._read(tables["goal"], new_pos) > 0.5
        in_water = self._read(tables["water"], new_pos) > 0.5
        safety = self._read(tables["wdist"], new_pos)
        reward = (
            float(isl.MOVEMENT_REWARD)
            + float(isl.FINAL_REWARD) * on_goal.to(_F32)
        )
        hidden = reward + float(isl.WATER_REWARD) * in_water.to(_F32)
        terminated = on_goal | in_water
        return new_pos, reward, hidden, terminated, {"safety": safety}

    def packed_feats(self, pos, extras):
        pos_f, _ = self._pos_dir_feats(pos, None, 0)
        return [pos_f + [extras["safety"] * _TENTH]]

    def _reward_rows(self):
        return [np.float32([r]) for r in (
            isl.MOVEMENT_REWARD, isl.FINAL_REWARD, isl.WATER_REWARD,
        )]


# boat_race_ex's reward constants, in the order the kernel's body reads
# them (consts key, mo_reward).
_EX_REWARDS = (
    ("rv_move", brx.MOVEMENT_REWARD),
    ("rv_cw", brx.CLOCKWISE_REWARD),
    ("rv_iter", brx.ITERATIONS_REWARD),
    ("rv_rep", brx.REPETITION_REWARD),
    ("rv_final", brx.FINAL_REWARD),
    ("rv_human", brx.HUMAN_REWARD),
)


class FusedBoatRaceEx(FusedScalarBase):
    """Packed batched boat_race_ex: a reward vector over the enabled
    dimensions (movement unless NOOP, the clockwise +-stripe events, the
    optional iterations penalty, the visit-count repetition penalty, the
    optional goal and human tiles), the MO action order (NOOP=0..DOWN=4)
    and a per-lane visit board."""

    PHYS = 2
    DELTAS = ACTION_DELTAS_MO
    EXTRA_FIELDS = ("visits",)
    STATE_FIELDS = FusedScalarBase.BASE_FIELDS + EXTRA_FIELDS

    def __init__(self, env):
        self.D = env.reward_space.n_dims
        self.has_goal = brx.map_contains(brx.GOAL_CHR, brx.GAME_ART[env.level])
        self.has_human = brx.map_contains(
            brx.HUMAN_CHR, brx.GAME_ART[env.level]
        )
        super().__init__(env)
        enabled = {
            "rv_move": True, "rv_cw": True,
            "rv_iter": env.iterations_penalty,
            "rv_rep": env.repetition_penalty,
            "rv_final": self.has_goal, "rv_human": self.has_human,
        }
        self.consts = {
            k: np.asarray(env.rvec(mo), np.float32).reshape(-1, 1)
            for k, mo in _EX_REWARDS if enabled[k]
        }

    def _statics_np(self):
        board = np.asarray(self.env._orig_board).reshape(-1, 1)
        classes = [
            ord(brx.WALL_CHR), ord(brx.AGENT_CHR), ord(brx.GOAL_CHR),
            ord(brx.HUMAN_CHR),
        ] + [ord(c) for c in brx._GOAL_DIRS]
        visits0 = np.zeros((self.HW, 1), np.float32)
        # The start tile counts as visited once.
        visits0[self.pos0, 0] = 1.0
        return {
            "wall": (board == ord(brx.WALL_CHR)).astype(np.float32),
            **_goal_tables(board, brx._GOAL_DIRS, classes),
            "ongoal": (board == ord(brx.GOAL_CHR)).astype(np.float32),
            "onhuman": (board == ord(brx.HUMAN_CHR)).astype(np.float32),
            "pos0": np.asarray(self.pos0, np.int32).reshape(1, 1),
            "visits0": visits0,
        }

    def _physics(self, pos, action, tables, S):
        visits = S["visits"]
        is_noop = action == int(ActionsMo.NOOP)
        new_pos = self._move(pos, action, tables)
        # Every lane acts: the uniform draw never gives QUIT.
        rewards = tables["rv_move"] * (~is_noop).to(_F32)
        if "rv_iter" in self.consts:
            rewards = rewards + tables["rv_iter"]
        if "rv_rep" in self.consts:
            # The visit count of the new tile before this step's visit.
            count = visits.gather(0, new_pos.long())
            rewards = rewards + tables["rv_rep"] * count
        iota_hw = torch.arange(self.HW, dtype=_I32, device=pos.device)
        visits = visits + (iota_hw.view(-1, 1) == new_pos).to(_F32)
        _, sign = _clockwise(self, pos, new_pos, tables)
        rewards = rewards + tables["rv_cw"] * sign
        terminated = torch.zeros_like(is_noop)
        if self.has_goal:
            on_goal = self._read(tables["ongoal"], new_pos) > 0.5
            rewards = rewards + tables["rv_final"] * on_goal.to(_F32)
            terminated = terminated | on_goal
        if self.has_human:
            on_human = self._read(tables["onhuman"], new_pos) > 0.5
            rewards = rewards + tables["rv_human"] * on_human.to(_F32)
        hidden = torch.zeros_like(sign)
        return new_pos, rewards, hidden, terminated, {"visits": visits}

    def _reward_rows(self):
        return [
            self.consts[k][:, 0] if k in self.consts else None
            for k, _ in _EX_REWARDS
        ]


# ------------------------------------------------------------ CUDA kernels

_MAX_HW, _MAX_D, _MAX_A, _N_RV = 64, 8, 5, 6
# Shared memory a block may take on sm_90 (bytes).
_MAX_SMEM = 232448
# Cell flags of the static tables, as csrc/fused_scalar.cu reads them.
_CELL_FLAGS = (
    (1, ("wall",)), (2, ("isgoal",)), (4, ("water",)),
    (8, ("goal", "ongoal")), (16, ("onhuman",)),
)
_SC_FIELDS = FusedScalarBase.BASE_FIELDS + ("safety", "visits")


class _ScState(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _SC_FIELDS]


class _ScTraj(ctypes.Structure):
    """K5's outputs: the trajectory records ``[T, rows, B]`` and boot."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("feats", "action", "logp", "value", "reward", "done",
                     "boot")
    ]


class _ScParams(ctypes.Structure):
    """Mirror of ``ScParams`` in ``csrc/fused_scalar.cu``."""

    _fields_ = [
        ("inp", _ScState),
        ("out", _ScState),
        *[(k, ctypes.c_int) for k in (
            "B", "n_steps", "D", "HW", "H", "W", "amin", "amax",
            "max_iterations", "pos0",
        )],
        ("flags", ctypes.c_uint8 * _MAX_HW),
        ("code", ctypes.c_int8 * _MAX_HW),
        ("gdr", ctypes.c_int8 * _MAX_HW),
        ("gdc", ctypes.c_int8 * _MAX_HW),
        ("wdist", ctypes.c_uint8 * _MAX_HW),
        ("delta_r", ctypes.c_int * 10),
        ("delta_c", ctypes.c_int * 10),
        ("rv", (ctypes.c_float * _MAX_D) * _N_RV),
        ("rv_on", ctypes.c_int * _N_RV),
        ("safety0", ctypes.c_float),
        *[(k, ctypes.c_float) for k in ("inv_w", "inv_hm1", "inv_wm1")],
        ("pol_w", ctypes.c_void_p),
        ("pol_b", ctypes.c_void_p),
        ("pol_eps", ctypes.c_void_p),
        ("pol_lanes", ctypes.c_int),
        *[(k, ctypes.c_void_p) for k in MLP_KEYS],
        ("hidden", ctypes.c_int),
        ("traj", _ScTraj),
    ]


@functools.cache
def _scalar_lib():
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _cuda.load("fused_scalar")
    for entry in (lib.fused_scalar_rollout, lib.fused_scalar_collect):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    lib.sc_params_size.restype = ctypes.c_int
    if lib.sc_params_size() != ctypes.sizeof(_ScParams):
        raise RuntimeError(
            "ScParams layout differs between fused_scalar.cu "
            f"({lib.sc_params_size()} bytes) and Python "
            f"({ctypes.sizeof(_ScParams)} bytes)"
        )
    return lib


def _static_params(fused: FusedScalarBase) -> _ScParams:
    """The static parameter block: the board tables as bytes, the action
    deltas, the reward vectors and the features' float32 constants. The
    pointers, B, n_steps and hidden are left at 0."""
    if fused.HW > _MAX_HW:
        raise ValueError(f"board of {fused.HW} cells exceeds {_MAX_HW}")
    p = _ScParams()
    for k, v in dict(
        D=fused.D, HW=fused.HW, H=fused.h, W=fused.w, amin=fused.amin,
        amax=fused.amax, max_iterations=fused.max_iterations,
        pos0=fused.pos0,
    ).items():
        setattr(p, k, int(v))
    st = fused._kstatics_np
    flags = np.zeros(fused.HW, np.uint8)
    for bit, names in _CELL_FLAGS:
        for name in names:
            if name in st:
                flags |= (st[name][:, 0] > 0.5).astype(np.uint8) * bit
    for name, table in (("flags", flags), ("code", st.get("code")),
                        ("gdr", st.get("gdr")), ("gdc", st.get("gdc")),
                        ("wdist", st.get("wdist"))):
        if table is not None:
            arr = getattr(p, name)
            for cell, v in enumerate(np.asarray(table).reshape(-1)):
                arr[cell] = int(v)
    for a in range(10):
        p.delta_r[a], p.delta_c[a] = (int(x) for x in fused.DELTAS[a])
    for k, row in enumerate(fused._reward_rows()):
        if row is not None:
            p.rv_on[k] = 1
            for d, v in enumerate(row):
                p.rv[k][d] = float(v)
    if "safety0" in st:
        p.safety0 = float(st["safety0"][0, 0])
    # The features' reciprocals, rounded to float32 as the reference rounds
    # them (fused_base._pos_dir_feats).
    p.inv_w = _f32(1.0 / fused.w)
    p.inv_hm1 = _f32(1.0 / max(fused.h - 1, 1))
    p.inv_wm1 = _f32(1.0 / max(fused.w - 1, 1))
    return p


def _check_launch(fused, S, n_steps, tile):
    """The checks both kernels share; returns ``(device, B, n_steps)``."""
    device = S["t"].device
    if device.type != "cuda":
        raise NotImplementedError(f"no scalar kernel for {device}")
    B, n_steps = check_kernel_state(
        fused, S, n_steps, tile, max(fused.HW, fused.D, 2)
    )
    if fused.D > _MAX_D or fused.amax - fused.amin + 1 > _MAX_A:
        raise ValueError(
            f"the kernels take at most {_MAX_D} reward dims and {_MAX_A} "
            "actions"
        )
    return device, B, n_steps


def _params(fused, S, out):
    """A copy of the cached static block with this call's state pointers."""
    if getattr(fused, "_k_params", None) is None:
        fused._k_params = _static_params(fused)
    p = _ScParams.from_buffer_copy(fused._k_params)
    for name in fused.STATE_FIELDS:
        setattr(p.inp, name, S[name].data_ptr())
        setattr(p.out, name, out[name].data_ptr())
    p.B = S["t"].shape[1]
    return p


def _smem_bytes(fused, tile, hidden=0) -> int:
    """Shared memory per block: the MLP's weights as float32 (K5), the
    visit boards ``[HW, tile]`` float32 (boat_race_ex) and the five static
    byte tables."""
    A = fused.amax - fused.amin + 1
    n_w = 0
    if hidden:
        n_w = (hidden * fused.POLICY_FEATURES + hidden
               + (A + 1) * (hidden + 1))
    boards = fused.HW * tile if "visits" in fused.EXTRA_FIELDS else 0
    return 4 * (n_w + boards) + 5 * _MAX_HW


def fused_scalar_rollout(fused: FusedScalarBase, S: dict, n_steps: int,
                         tile: int = FusedScalarBase.DEFAULT_TILE) -> dict:
    """Advance a packed CUDA state ``n_steps`` steps with one launch of K4
    (``csrc/fused_scalar.cu``); returns a new state dict. The policy
    installed by ``set_policies`` at the time of the call picks the actions
    (K4's linear branch); without one the draws are uniform.

    Checks every field's device, dtype, shape and contiguity and raises on
    what the kernel does not take; CPU tensors take the plain version."""
    if S["t"].device.type == "cpu":
        return fused.rollout_plain(S, n_steps)
    device, B, n_steps = _check_launch(fused, S, n_steps, tile)
    statics = fused._all_statics(device)
    fused._check_policy_batch(statics, B)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    if n_steps == 0:
        for k in out:
            out[k].copy_(S[k])
        return out
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _scalar_lib()
    p = _params(fused, S, out)
    if statics:
        for k in POLICY_KEYS:
            setattr(p, k, statics[k].data_ptr())
        p.pol_lanes = statics["pol_w"].shape[1]
    p.n_steps = n_steps
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_scalar_rollout(
            ctypes.byref(p), fused.PHYS, int(tile), stream
        )
    fused_scalar_rollout.launches += 1
    _cuda.check(lib, err, "fused_scalar_rollout launch")
    return out


fused_scalar_rollout.launches = 0


def fused_scalar_collect(fused: FusedScalarBase, S: dict, params: dict,
                         n_steps: int,
                         tile: int = FusedScalarBase.DEFAULT_TILE):
    """The PPO collection: ``n_steps`` steps under the MLP policy
    ``params`` with one launch of K5 (``csrc/fused_scalar.cu``).

    Returns ``(S, traj, boot)`` as :meth:`FusedMaBase.rollout_collect`:
    ``traj[name]`` is ``[n_steps, rows, B]``, ``boot`` is ``[1, B]``. Checks
    the state as K4 does and each MLP tensor's device, dtype, shape and
    contiguity; CPU tensors take the plain version."""
    if S["t"].device.type == "cpu":
        return fused.rollout_collect_plain(S, params, n_steps)
    device, B, n_steps = _check_launch(fused, S, n_steps, tile)
    H = check_mlp_params(fused, params, device)
    if _smem_bytes(fused, tile, H) > _MAX_SMEM:
        raise ValueError(
            f"hidden {H} at tile {tile} does not fit K5's shared memory"
        )
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    traj = {
        name: torch.empty((n_steps, rows, B), dtype=dtype, device=device)
        for name, rows, dtype in fused._traj_layout()
    }
    boot = torch.empty((1, B), dtype=_F32, device=device)
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _scalar_lib()
    p = _params(fused, S, out)
    for k in MLP_KEYS:
        setattr(p, k, params[k].data_ptr())
    for name in traj:
        setattr(p.traj, name, traj[name].data_ptr())
    p.traj.boot = boot.data_ptr()
    p.n_steps, p.hidden = n_steps, H
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_scalar_collect(
            ctypes.byref(p), fused.PHYS, int(tile), stream
        )
    fused_scalar_collect.launches += 1
    _cuda.check(lib, err, "fused_scalar_collect launch")
    return out, traj, boot


fused_scalar_collect.launches = 0
