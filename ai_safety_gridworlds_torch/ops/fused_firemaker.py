"""Fused batched firemaker_ex_ma rollout and PPO collection: plain PyTorch
body and CUDA kernels.

Port of ``ai_safety_gridworlds_tpu/ops/fused_firemaker.py``. The whole
multi-agent step (action draws, randomized agent order, every agent's
sub-step -- move, stop button, workshop, fire spread, territory -- finalize
and auto-reset) runs over the packed layout: batch lanes on the last axis,
``fire`` is ``[H*W, B]``, positions are flat cell indices ``[n_agents, B]``,
scalars are ``[1, B]``. Actions come from uniform draws, from per-lane
linear policies (``set_policies``) or, in the PPO collection, from the MLP
policy, all on the features of :meth:`FusedFiremaker._policy_feats`.

Two implementations of the same step:

* ``FusedFiremaker._step``, the plain PyTorch version, which mirrors the JAX
  step body op for op. ``rollout`` and ``rollout_collect`` run it for CPU
  tensors; tests and the on-card comparison run it anywhere through
  ``rollout_plain``/``rollout_collect_plain``/``step``.
* The hand-written CUDA kernels of ``csrc/fused_firemaker.cu``, which
  ``rollout`` and ``rollout_collect`` launch for CUDA tensors, one launch
  per call with every lane's state on chip for all ``n_steps``:
  :func:`fused_firemaker_rollout` (K1; uniform or linear-policy actions)
  and :func:`fused_firemaker_collect` (K3; MLP actions and the streamed
  trajectory).

Deliberate deviation from the JAX package: the port's default stencil is
the product form (``mxu_stencil=False``), where the reference defaults to
the log-survival matmul form that suits the TPU's matrix unit. The product
form is exact in float32 and is the form the CUDA kernels implement, so K1
is bit-equal to the plain version and the plain version is bit-identical to
the JAX step run eagerly. ``mxu_stencil=True`` keeps the log form in the
plain version as one float32 ``[HW, HW] @ [HW, B]`` matmul (the bf16 hi/lo
split of the reference was an MXU workaround); a CUDA launch with it raises
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.actions import (
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
)
from ai_safety_gridworlds_torch.ops.fused_island_ma import _table_sel

_I32 = torch.int32
_F32 = torch.float32

QUIT_R = int(TerminationReason.QUIT)
NOOP = int(ActionsMo.NOOP)
QUIT = int(ActionsMo.QUIT)
UP_DIR = int(Directions.UP)
_TENTH = _f32(0.1)

# Reward constants, in the order the CUDA kernel indexes them.
REWARD_KINDS = (
    "AGENT_MOVEMENT_REWARD",
    "AGENT_WORKSHOP_WORK_REWARD",
    "AGENT_WORKSHOP_ENERGY_REWARD",
    "SUPERVISOR_MOVEMENT_REWARD",
    "SUPERVISOR_EXTERNAL_FIRE_REWARD",
    "SUPERVISOR_TRESPASSING_REWARD",
    "SUPERVISOR_STOP_BUTTON_REWARD",
    "SUPERVISOR_WORKSHOP_REWARD",
)


class FusedFiremaker(FusedMaBase):
    """Packed batched firemaker with a single-kernel rollout."""

    # Threads per block of the CUDA kernels (one warp per lane, so tile / 32
    # lanes per block).
    DEFAULT_TILE = 256
    POLICY_FEATURES = 6

    def __init__(self, env, mxu_stencil=False):
        self._mxu_stencil = bool(mxu_stencil)
        self.adm = int(env.action_direction_mode)
        self.odm = int(env.observation_direction_mode)
        if self.odm == 2 and self.adm == 0:
            raise NotImplementedError(
                "observation mode 2 with fixed action mode"
            )
        self.has_dirs = self.adm != 0 or self.odm != 0
        self.env = env
        self.n = env.n_agents
        self.D = env.reward_space.n_dims
        h, w = env._wall_mask.shape
        self.h, self.w, self.HW = h, w, h * w
        wall = np.asarray(env._wall_mask)
        if not (
            wall[0, :].all()
            and wall[-1, :].all()
            and wall[:, 0].all()
            and wall[:, -1].all()
        ):
            raise NotImplementedError(
                "fused fire stencil requires an all-wall border "
                "(absorbs roll wrap-around)"
            )
        cfg = env.cfg

        def flat(mask):
            return np.asarray(mask, np.float32).reshape(self.HW, 1)

        # The same keys and values as the JAX FusedFiremaker.consts, except
        # that the log-form matrix is one float32 "spread_logw".
        self.consts = {
            "wall": flat(env._wall_mask),
            "workshop": flat(env._workshop_mask),
            "button": flat(env._button_mask),
            "territory": flat(env._territory_mask),
            "external": flat(env._external_mask),
            "spreadable": flat(env._spreadable),
        }
        self.consts["code"] = (
            1.0 * self.consts["wall"]
            + 2.0 * self.consts["workshop"]
            + 4.0 * self.consts["button"]
            + 8.0 * self.consts["territory"]
            + 16.0 * self.consts["external"]
        )
        # Separable grouping of the stencil (the reference's order, which the
        # product is taken in): rows of equal dr, each row's (dc, p) terms
        # sorted; rows with identical term lists share one polynomial.
        rows: dict = {}
        for dr, dc, p in env._spread_offsets:
            rows.setdefault(dr, []).append((dc, float(p)))
        self.spread_rows = sorted(
            (dr, tuple(sorted(terms))) for dr, terms in rows.items()
        )
        self.spread_polys = sorted({terms for _, terms in self.spread_rows})
        self.spread_dcs = sorted({dc for _, dc, _ in env._spread_offsets})
        if self._mxu_stencil:
            # Banded log-survival matrix over flat indices, with the roll
            # form's wrap-around (wrapped reads land on the all-wall border).
            logw = np.zeros((self.HW, self.HW), np.float64)
            i = np.arange(self.HW)
            for dr, dc, p in env._spread_offsets:
                logw[i, (i - (dr * w + dc)) % self.HW] = np.log1p(-float(p))
            self.consts["spread_logw"] = logw.astype(np.float32)
        self.start_pos_flat = np.asarray(
            env._start_pos[:, 0] * w + env._start_pos[:, 1], np.int32
        ).reshape(self.n, 1)
        self.sup = env.supervisor_idx  # -1 when absent
        self.has_sup = env.has_supervisor
        self.n_workers = env.n_workers
        self.press_duration = int(cfg["STOP_BUTTON_PRESS_EFFECT_DURATION"])
        self.cont_p = float(np.float32(cfg["FIRE_CONTINUATION_PROBABILITY"]))
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)

        # Reward vectors tiled over the [n*D] reward rows.
        self.rv = {
            k: np.tile(np.asarray(env.rvec(cfg[k]), np.float32), self.n)
            .reshape(self.n * self.D, 1)
            for k in REWARD_KINDS
        }
        row_agent = (np.arange(self.n * self.D) // self.D).astype(np.int32)
        self.consts["row_agent"] = row_agent.reshape(self.n * self.D, 1)
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )
        v_rows = np.arange(self.n * 5, dtype=np.int32)
        self.consts["vrow_agent"] = (v_rows // 5).reshape(self.n * 5, 1)
        self.consts["vrow_col"] = (v_rows % 5).reshape(self.n * 5, 1)
        self.consts["start_pos"] = self.start_pos_flat
        for k in self.rv:
            self.consts["rv_" + k] = self.rv[k]

        # Per-step PRF draw sites: 0 = actions (idx = agent), 1 = agent
        # order (idx = row), then one per sub-step slot (idx = cell): burning
        # and spread-eligible cells are disjoint, so one uniform per cell
        # serves both Bernoulli draws.
        self.n_sites = 2 + self.n
        self.STATE_FIELDS = self.BASE_FIELDS + (
            ("act_dir", "obs_dir") if self.has_dirs else ()
        )
        self._device_cache = {}

    BASE_FIELDS = (
        "fire", "pos", "reasons", "step_types", "countdown", "ext_fires",
        "visits", "at_workshop", "t", "key", "draw_ctr",
        "stats_rewards", "stats_episodes",
    )

    def field_spec(self, name):
        """(rows, dtype) of a packed state field."""
        n, HW = self.n, self.HW
        return {
            "fire": (HW, _F32), "pos": (n, _I32), "reasons": (n, _I32),
            "step_types": (n, _I32), "countdown": (1, _I32),
            "ext_fires": (1, _I32), "visits": (n * 5, _I32),
            "at_workshop": (n, _F32), "t": (1, _I32),
            "key": (2, torch.uint32), "draw_ctr": (1, torch.uint32),
            "stats_rewards": (n * self.D, _F32),
            "stats_episodes": (1, _I32), "act_dir": (n, _I32),
            "obs_dir": (n, _I32),
        }[name]

    # ------------------------------------------------------------- packing

    def init_packed(self, seed: int, batch: int, device, tile=None) -> dict:
        """The packed initial state of ``batch`` lanes on ``device``; equal
        field by field to the JAX package's ``init_packed(seed, batch)``.
        The kernels take every configuration at every tile, so ``tile`` is
        unused."""
        del tile
        n = self.n
        keys = torch.from_numpy(prng.derive_keys(seed, batch))
        self.packed_batch = int(batch)
        state = {
            "fire": torch.zeros((self.HW, batch), dtype=_F32),
            "pos": torch.from_numpy(self.start_pos_flat).repeat(1, batch),
            "reasons": torch.full((n, batch), NONE, dtype=_I32),
            "step_types": torch.full((n, batch), FIRST, dtype=_I32),
            "countdown": torch.zeros((1, batch), dtype=_I32),
            "ext_fires": torch.zeros((1, batch), dtype=_I32),
            "visits": torch.zeros((n * 5, batch), dtype=_I32),
            "at_workshop": torch.zeros((n, batch), dtype=_F32),
            "t": torch.zeros((1, batch), dtype=_I32),
            "key": keys,
            "draw_ctr": torch.zeros((1, batch), dtype=torch.uint32),
            "stats_rewards": torch.zeros((n * self.D, batch), dtype=_F32),
            "stats_episodes": torch.zeros((1, batch), dtype=_I32),
        }
        if self.has_dirs:
            state["act_dir"] = torch.full((n, batch), UP_DIR, dtype=_I32)
            state["obs_dir"] = torch.full((n, batch), UP_DIR, dtype=_I32)
        return {k: v.to(device) for k, v in state.items()}

    def _on(self, device) -> dict:
        """The consts (and a few derived tables) as tensors on ``device``."""
        key = str(device)
        cache = self._device_cache.get(key)
        if cache is None:
            cache = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.consts.items()
            }
            cache["_code_i32"] = cache["code"].view(-1).to(_I32)
            cache["_cont_p"] = torch.tensor(self.cont_p, dtype=_F32, device=device)
            self._device_cache[key] = cache
        return cache

    # ----------------------------------------------------------- step body

    def _spread_cum(self, src_f, consts):
        """Per-cell fire-spread probability ``1 - prod(1 - p*src)`` over the
        stencil, from the [HW, lanes] 0/1 source board."""
        if self._mxu_stencil:
            # Summed log-survival over burning neighbours, then one exp. No
            # burning neighbour -> s = 0 -> cum = 0 exactly.
            s = torch.matmul(consts["spread_logw"], src_f)
            return 1.0 - torch.exp(s)
        # Product form in the reference's separable order: one roll per
        # column offset, each distinct row polynomial once, rolled to each
        # row offset that uses it, rows multiplied in ascending dr.
        shifted = {
            dc: (torch.roll(src_f, dc, 0) if dc else src_f)
            for dc in self.spread_dcs
        }
        polys = {}
        for terms in self.spread_polys:
            y = None
            for dc, p_off in terms:
                f_term = 1.0 - p_off * shifted[dc]
                y = f_term if y is None else y * f_term
            polys[terms] = y
        prod = None
        for dr, terms in self.spread_rows:
            y = polys[terms]
            y = torch.roll(y, dr * self.w, 0) if dr else y
            prod = y if prod is None else prod * y
        return 1.0 - prod

    def _policy_feats(self, pos, at_work, countdown, ext_fires, t):
        """Per-agent [1, B] policy-feature rows, observed at the start of
        the step after the auto-reset: normalised row and column, the
        workshop flag, countdown / 10, external fires / 10 and
        t / max_iterations."""
        feats = []
        for j in range(self.n):
            pos_f, _ = self._pos_dir_feats(pos, None, j)
            feats.append(pos_f + [
                at_work[j : j + 1],
                countdown.to(_F32) * _TENTH,
                ext_fires.to(_F32) * _TENTH,
                t.to(_F32) * _f32(1.0 / max(self.max_iterations, 1)),
            ])
        return feats

    def feats_of(self, S):
        return self._policy_feats(
            S["pos"], S["at_workshop"], S["countdown"], S["ext_fires"],
            S["t"],
        )

    def _step(self, S: dict, statics=None, collect_draws: bool = False):
        """One full MA step on packed tensors: the plain version of K1 and
        K3. ``statics`` holds the policy (``pol_*`` or ``mlp_*``
        tensors); ``None`` reads the one installed by ``set_policies``."""
        n, D, HW, W = self.n, self.D, self.HW, self.w
        dev = S["t"].device
        c = self._on(dev)
        if statics is None:
            statics = self._all_statics(dev)
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        iota_n = torch.arange(n, dtype=_I32, device=dev).view(n, 1)
        iota_hw = torch.arange(HW, dtype=_I32, device=dev).view(HW, 1)
        code = c["_code_i32"]
        territory = c["territory"] > 0.5
        spreadable = c["spreadable"] > 0.5

        # ---- auto-reset lanes whose episode ended last step
        types = S["step_types"]
        over = ((types == LAST) | (types == DEAD)).all(dim=0, keepdim=True)
        fire = torch.where(over, 0.0, S["fire"])
        pos = torch.where(over, c["start_pos"], S["pos"])
        reasons = torch.where(over, NONE, S["reasons"])
        types = torch.where(over, FIRST, types)
        countdown = torch.where(over, 0, S["countdown"])
        ext_fires = torch.where(over, 0, S["ext_fires"])
        visits = torch.where(over, 0, S["visits"])
        at_work = torch.where(over, 0.0, S["at_workshop"])
        t = torch.where(over, 0, S["t"])
        if self.has_dirs:
            act_dir = torch.where(over, UP_DIR, S["act_dir"])
            obs_dir = torch.where(over, UP_DIR, S["obs_dir"])

        ctr0 = (S["draw_ctr"].to(torch.int64) * self.n_sites) & 0xFFFF_FFFF
        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(pos, at_work, countdown, ext_fires, t)
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = torch.zeros((n * D, actions.shape[1]), dtype=_F32, device=dev)
        rv = {k: c["rv_" + k] for k in REWARD_KINDS}
        arm = {j: c[f"arm_{j}"] for j in range(n)}
        draws = []

        def bit(v, k):
            return ((v >> k) & 1) != 0

        for slot in range(n):
            i = order[slot : slot + 1]  # [1, B] acting agent index
            il = i.long()
            sel = iota_n == i
            a = actions.gather(0, il)
            acting = a >= 0
            actf = acting.to(_F32)
            is_quit = a == QUIT
            is_noop = a == NOOP
            dead_i = (sel & (reasons != NONE)).any(dim=0, keepdim=True)
            active = acting & ~is_quit & ~dead_i
            t = t + acting.to(_I32)

            # --- direction modes: observation facing before the move,
            # action facing after it.
            is_move = (a >= 1) & (a <= 4)
            abs_action = a
            if self.has_dirs:
                a_cl = a.clamp(0, 9)
                dir_i = act_dir.gather(0, il)
                odir_i = obs_dir.gather(0, il)
                if self.odm != 0:
                    if self.odm == 1:
                        otab = MODE_DIR_TABLES[1 if self.adm in (1, 2) else 0]
                    else:
                        otab = MODE_DIR_TABLES[2]
                    new_odir = _table_sel(otab, a_cl, odir_i)
                    obs_dir = torch.where(sel & active, new_odir, obs_dir)
                if self.adm != 0:
                    rel = _table_sel(MODE_DIR_TABLES[1], a_cl, dir_i)
                    abs_move = torch.full_like(rel, int(DIR_TO_ACTION_MO[0]))
                    for d in range(1, 4):
                        abs_move = torch.where(
                            rel == d, int(DIR_TO_ACTION_MO[d]), abs_move
                        )
                    abs_action = torch.where(is_move, abs_move, a)
                    new_adir = _table_sel(
                        MODE_DIR_TABLES[self.adm], a_cl, dir_i
                    )
                    act_dir = torch.where(sel & active, new_adir, act_dir)

            # --- move, blocked by walls and other agents
            pos_i = pos.gather(0, il)
            delta = torch.zeros_like(pos_i)
            for action, step in (
                (ActionsMo.LEFT, -1), (ActionsMo.RIGHT, 1),
                (ActionsMo.UP, -W), (ActionsMo.DOWN, W),
            ):
                delta = torch.where(abs_action == int(action), step, delta)
            cand = pos_i + delta
            occ = ((pos == cand) & ~sel).any(dim=0, keepdim=True)
            on_board = (cand >= 0) & (cand < HW)
            wall_at = on_board & bit(code[cand.clamp(0, HW - 1).long()], 0)
            moved = active & is_move & ~wall_at & ~occ
            pos = torch.where(sel, torch.where(moved, cand, pos_i), pos)

            # QUIT terminates the acting agent.
            reasons = torch.where(sel & (is_quit & ~dead_i), QUIT_R, reasons)

            # Movement reward.
            sel_nd = (c["row_agent"] == i).to(_F32)
            if self.has_sup:
                move_tiled = torch.where(
                    i == self.sup,
                    rv["SUPERVISOR_MOVEMENT_REWARD"],
                    rv["AGENT_MOVEMENT_REWARD"],
                )
            else:
                move_tiled = rv["AGENT_MOVEMENT_REWARD"]
            rewards = rewards + move_tiled * sel_nd * (
                active & ~is_noop
            ).to(_F32)

            # Every agent's static tile bits at its post-move cell, plus
            # the fire bit (64).
            pos_l = pos.long()
            v_agents = code[pos_l] + 64 * (fire.gather(0, pos_l) > 0.5).to(_I32)
            v_at = v_agents.gather(0, il)
            conds = torch.cat(
                [bit(v_at, k) for k in (4, 3, 1, 6, 2)], dim=0
            ).to(_I32)  # external, internal, workshop, fire, button
            visits = visits + (
                conds.repeat(n, 1)
                * (c["vrow_agent"] == i).to(_I32)
                * active.to(_I32)
            )

            # --- stop button
            on_button = bit(v_agents, 2)
            countdown2 = torch.where(
                on_button.any(dim=0, keepdim=True),
                2 + self.press_duration,
                countdown,
            )
            if self.has_sup:
                sup_on_btn = on_button[self.sup : self.sup + 1]
                rewards = rewards + (
                    rv["SUPERVISOR_STOP_BUTTON_REWARD"]
                    * arm[self.sup]
                    * (sup_on_btn & (ext_fires == 0)).to(_F32)
                    * actf
                )
            countdown2 = (countdown2 - 1).clamp(min=0)

            # --- workshop
            at_w = bit(v_agents, 1)
            for j in range(n):
                at_w_j = at_w[j : j + 1]
                if self.has_sup and j == self.sup:
                    rewards = rewards + (
                        rv["SUPERVISOR_WORKSHOP_REWARD"]
                        * arm[j]
                        * (at_w_j & (ext_fires == 0)).to(_F32)
                        * actf
                    )
                    working = at_w_j & (ext_fires != 0)
                else:
                    working = at_w_j
                waf = (working & (countdown2 == 0)).to(_F32) * actf
                rewards = rewards + rv["AGENT_WORKSHOP_WORK_REWARD"] * arm[0] * waf
                if self.env.amount_agents > 2 and self.n_workers > 1:
                    rewards = (
                        rewards + rv["AGENT_WORKSHOP_WORK_REWARD"] * arm[1] * waf
                    )
                rewards = rewards + rv["AGENT_WORKSHOP_ENERGY_REWARD"] * arm[j] * waf
            at_work2 = at_w.to(_F32)

            # --- fire: burning cells without an agent, plus the cells of
            # workers at an active workshop, spread and keep burning.
            agent_oh = [iota_hw == pos[j : j + 1] for j in range(n)]
            on_agent = agent_oh[0]
            for j in range(1, n):
                on_agent = on_agent | agent_oh[j]
            fire_cleared = (fire > 0.5) & ~on_agent
            sources = fire_cleared
            for j in range(self.n_workers):
                sources = sources | (
                    agent_oh[j] & at_w[j : j + 1] & (countdown2 == 0)
                )
            cum = self._spread_cum(sources.to(_F32), c)
            cum = torch.where(~fire_cleared & spreadable, cum, 0.0)
            u_fire = prng.uniform(key_hi, key_lo, ctr0 + (2 + slot), iota_hw)
            spread_set = u_fire < cum
            cont_keep = u_fire < c["_cont_p"]
            fire2_f = torch.where(
                fire_cleared, cont_keep.to(_F32), spread_set.to(_F32)
            )
            if collect_draws:
                draws.append(dict(
                    spread_cells=cum > 0.0,
                    spread_set=spread_set,
                    cont_keep=cont_keep,
                    cum=cum,
                    u=u_fire,
                ))

            ext2 = ((fire2_f > 0.5) & ~territory).sum(
                dim=0, keepdim=True
            ).to(_I32)
            target = self.sup if self.has_sup else 0
            rewards = rewards + (
                rv["SUPERVISOR_EXTERNAL_FIRE_REWARD"]
                * arm[target]
                * ext2.to(_F32)
                * actf
            )

            # --- territory
            if self.has_sup:
                sup_on_terr = (agent_oh[self.sup] & territory).any(
                    dim=0, keepdim=True
                )
                rewards = rewards + (
                    rv["SUPERVISOR_TRESPASSING_REWARD"]
                    * arm[self.sup]
                    * (sup_on_terr & (ext2 == 0)).to(_F32)
                    * actf
                )

            # Commit drape state only for acting lanes.
            fire = torch.where(acting, fire2_f, fire)
            countdown = torch.where(acting, countdown2, countdown)
            ext_fires = torch.where(acting, ext2, ext_fires)
            at_work = torch.where(acting, at_work2, at_work)

        # ---- finalize
        types, done = self._finalize_types(t, reasons, types, over)
        out = {
            "fire": fire,
            "pos": pos,
            "reasons": reasons,
            "step_types": types,
            "countdown": countdown,
            "ext_fires": ext_fires,
            "visits": visits,
            "at_workshop": at_work,
            "t": t,
            "key": S["key"],
            "draw_ctr": ((S["draw_ctr"].to(torch.int64) + 1) & 0xFFFF_FFFF).to(
                torch.uint32
            ),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.to(_I32),
        }
        if self.has_dirs:
            out["act_dir"] = act_dir
            out["obs_dir"] = obs_dir
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": rewards,
                "over": over,
                "pol": pol,
                "slots": draws,
            }
        return out

    # ------------------------------------------------------------- interop

    def unpack_lane(self, S: dict, lane: int):
        """The packed lane as the generic path's ``FiremakerState``, a
        batch of one lane on ``S``'s device (key ``PRNGKey(0)``, as JAX's
        ``unpack_lane``)."""
        from ai_safety_gridworlds_torch.core import threefry
        from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import (
            FiremakerState,
        )

        n, h, w = self.n, self.h, self.w
        dev = S["t"].device

        def col(name):
            return S[name][:, lane]

        def dirs(name):
            if name in S:
                return col(name).to(_I32).view(1, n)
            return torch.full((1, n), UP_DIR, dtype=_I32, device=dev)

        pos = col("pos").to(_I32)
        return FiremakerState(
            t=col("t").to(_I32),
            key=threefry.PRNGKey(0, dev).view(1, 2),
            pos=torch.stack([pos // w, pos % w], dim=1).view(1, n, 2),
            step_types=col("step_types").view(1, n),
            termination_reasons=col("reasons").view(1, n),
            action_direction=dirs("act_dir"),
            observation_direction=dirs("obs_dir"),
            fire=(col("fire") > 0.5).view(1, h, w),
            countdown=col("countdown").to(_I32),
            ext_fires=col("ext_fires").to(_I32),
            is_at_workshop=(col("at_workshop") > 0.5).view(1, n),
            visits=col("visits").view(1, n, 5),
        )

    # ----------------------------------------------------------- CUDA path

    def _rollout_kernel(self, S, n_steps, tile, statics=None):
        return fused_firemaker_rollout(self, S, n_steps, tile, statics)

    def _collect_kernel(self, S, params, n_steps, tile, statics=None):
        return fused_firemaker_collect(self, S, params, n_steps, tile,
                                       statics)

    def _kernel_static(self, device) -> "_FmParams":
        """The kernels' parameter block with everything static filled in:
        the state, policy, MLP and trajectory pointers, B, n_steps and
        hidden stay 0 and are set per call, so that a policy installed or
        changed after the first launch reaches the next one. Built once per
        device. Holds the static board as cell bits ([HW] uint8 on
        ``device``, kept alive in the cache)."""
        cache = self._on(device)
        if "_k1_params" not in cache:
            bits = np.zeros(self.HW, np.uint8)
            for k, name in enumerate((
                "wall", "workshop", "button", "territory", "external",
                "spreadable",
            )):
                bits |= (self.consts[name].reshape(-1) > 0.5).astype(
                    np.uint8
                ) << k
            cache["_cell_bits"] = torch.from_numpy(bits).to(device)
            cache["_k1_params"] = _static_params(self, cache["_cell_bits"])
        return cache["_k1_params"]


# ------------------------------------------------------------ CUDA kernels

_MAX_N, _MAX_D, _MAX_TERMS, _MAX_A = 3, 8, 48, 5
# Stencil rows, bits of a row's window, and board cells (one 32-bit word of
# a thread's own cells) the kernels take.
_MAX_ROWS, _MAX_WIN, _MAX_HW = 8, 8, 1024
# Shared memory a block may take on sm_90 (bytes).
_MAX_SMEM = 232448


class _FmState(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_void_p)
        for name in FusedFiremaker.BASE_FIELDS + ("act_dir", "obs_dir")
    ]


class _FmTraj(ctypes.Structure):
    """K3's outputs: the trajectory records ``[T, rows, B]`` and boot."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("feats", "action", "logp", "value", "reward", "done",
                     "boot")
    ]


def _int_array(n):
    return ctypes.c_int * n


class _FmParams(ctypes.Structure):
    """Mirror of ``FmParams`` in ``csrc/fused_firemaker.cu``."""

    _fields_ = [
        ("inp", _FmState),
        ("out", _FmState),
        ("cell_bits", ctypes.c_void_p),
        *[(k, ctypes.c_int) for k in (
            "B", "n_steps", "D", "HW", "W", "adm", "odm", "randomize",
            "amin", "amax", "sup", "n_workers", "extra_work_row",
            "press_duration", "max_iterations",
        )],
        ("start_pos", _int_array(_MAX_N)),
        *[(k, ctypes.c_int) for k in (
            "n_terms", "n_rows", "win_bits", "ext_lo", "n_ext",
        )],
        ("term_row", _int_array(_MAX_TERMS)),
        ("term_bit", _int_array(_MAX_TERMS)),
        ("term_q", ctypes.c_float * _MAX_TERMS),
        ("row_base", _int_array(_MAX_ROWS)),
        ("cont_p", ctypes.c_float),
        ("rv", (ctypes.c_float * _MAX_D) * len(REWARD_KINDS)),
        ("dir_tab", ((ctypes.c_int * 4) * 10) * 3),
        ("dir_to_action", _int_array(4)),
        *[(k, ctypes.c_float) for k in (
            "inv_w", "inv_hm1", "inv_wm1", "inv_maxit",
        )],
        ("pol_w", ctypes.c_void_p),
        ("pol_b", ctypes.c_void_p),
        ("pol_eps", ctypes.c_void_p),
        ("pol_lanes", ctypes.c_int),
        *[(k, ctypes.c_void_p) for k in MLP_KEYS],
        ("hidden", ctypes.c_int),
        ("traj", _FmTraj),
    ]


@functools.cache
def _firemaker_lib():
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _cuda.load("fused_firemaker")
    for entry in (lib.fused_firemaker_rollout, lib.fused_firemaker_collect):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    lib.fm_params_size.restype = ctypes.c_int
    if lib.fm_params_size() != ctypes.sizeof(_FmParams):
        raise RuntimeError(
            "FmParams layout differs between fused_firemaker.cu "
            f"({lib.fm_params_size()} bytes) and Python "
            f"({ctypes.sizeof(_FmParams)} bytes)"
        )
    return lib


def _stencil(fused) -> dict:
    """The kernels' stencil tables. ``terms``: (row, window bit, q) in the
    reference's product order (rows of equal dr ascending, each row's
    (dc, p) ascending), q = float32(1 - float32(p)). Row r's window at cell
    c holds the sources at cells c - dr*W - dc for dc from the row's largest
    down, in bits 0, 1, ... (a term's bit is dcmax - dc) of ``win_bits``
    bits; it starts at bit c - ``row_base[r]`` of the extended source board,
    whose bit e holds cell (e + ``ext_lo``) mod HW, for e < ``n_ext``: the
    wrap-around of the roll form, read as one window per row. Raises
    ``ValueError`` for a stencil the kernels' tables do not hold."""
    HW, W = fused.HW, fused.w
    terms, row_off, widths = [], [], []
    for r, (dr, row) in enumerate(fused.spread_rows):
        dcs = [dc for dc, _ in row]
        row_off.append(dr * W + max(dcs))
        widths.append(max(dcs) - min(dcs) + 1)
        for dc, p_off in row:
            q = np.float32(1.0) - np.float32(p_off)
            terms.append((r, max(dcs) - dc, float(q)))
    win_bits = max(widths)
    ext_lo = min(-o for o in row_off)
    ext_hi = max(-o + win_bits - 1 for o in row_off)
    if (len(terms) > _MAX_TERMS or len(row_off) > _MAX_ROWS
            or win_bits > _MAX_WIN or ext_lo < -HW or ext_hi >= HW):
        raise ValueError("fire stencil too large for K1")
    return dict(terms=terms, win_bits=win_bits, ext_lo=ext_lo,
                n_ext=HW + ext_hi - ext_lo,
                row_base=[o + ext_lo for o in row_off])


def _static_params(fused, cell_bits) -> _FmParams:
    """The static parameter block: the board's cell bits, the stencil
    tables (``_stencil``), reward vectors, direction tables and the policy
    features' float32 constants. The pointers, B, n_steps and hidden are
    left at 0."""
    st = _stencil(fused)
    terms = st["terms"]
    p = _FmParams()
    p.cell_bits = cell_bits.data_ptr()
    env = fused.env
    for k, v in dict(
        D=fused.D, HW=fused.HW, W=fused.w, adm=fused.adm, odm=fused.odm,
        randomize=int(bool(env.randomize_agent_actions_order)),
        amin=fused.amin, amax=fused.amax, sup=fused.sup,
        n_workers=fused.n_workers,
        extra_work_row=int(env.amount_agents > 2 and fused.n_workers > 1),
        press_duration=fused.press_duration,
        max_iterations=fused.max_iterations, n_terms=len(terms),
        n_rows=len(st["row_base"]), win_bits=st["win_bits"],
        ext_lo=st["ext_lo"], n_ext=st["n_ext"],
    ).items():
        setattr(p, k, int(v))
    for j in range(fused.n):
        p.start_pos[j] = int(fused.start_pos_flat[j, 0])
    for k, (row, bit, q) in enumerate(terms):
        p.term_row[k], p.term_bit[k], p.term_q[k] = row, bit, q
    for r, base in enumerate(st["row_base"]):
        p.row_base[r] = base
    p.cont_p = fused.cont_p
    for r, kind in enumerate(REWARD_KINDS):
        for d in range(fused.D):
            p.rv[r][d] = float(fused.rv[kind][d, 0])
    for m, table in enumerate(MODE_DIR_TABLES):
        for a in range(10):
            for d in range(4):
                p.dir_tab[m][a][d] = int(table[a, d])
    for d in range(4):
        p.dir_to_action[d] = int(DIR_TO_ACTION_MO[d])
    # The features' reciprocals, rounded to float32 as the reference
    # rounds them (fused_base._pos_dir_feats, _policy_feats).
    p.inv_w = _f32(1.0 / fused.w)
    p.inv_hm1 = _f32(1.0 / max(fused.h - 1, 1))
    p.inv_wm1 = _f32(1.0 / max(fused.w - 1, 1))
    p.inv_maxit = _f32(1.0 / max(fused.max_iterations, 1))
    return p


def _smem_bytes(fused: FusedFiremaker, tile: int, hidden: int = 0) -> int:
    """Shared memory per block of K1 (``hidden`` 0) or K3, as
    ``fm_smem`` in ``csrc/fused_firemaker.cu`` lays it out in 4-byte
    words: the block's K3 weights (w2's rows H + 1 apart), reward vectors,
    stencil table and cell bits, then per lane (``tile // 32`` of them) the
    fire board, the extended source board and one spare word, and K3's
    hidden units [n, H + 1]."""
    st = _stencil(fused)
    A = fused.amax - fused.amin + 1
    weights = (hidden * fused.POLICY_FEATURES + hidden
               + (A + 1) * (hidden + 1) + A + 1) if hidden else 0
    block = (weights + len(REWARD_KINDS) * _MAX_D
             + (len(st["row_base"]) << st["win_bits"]) + (fused.HW + 3) // 4)
    per_lane = ((fused.HW + 31) // 32 + (st["n_ext"] + 31) // 32 + 1
                + (fused.n * (hidden + 1) if hidden else 0))
    return 4 * (block + _lanes_per_block(tile) * per_lane)


def _lanes_per_block(tile: int) -> int:
    """Batch lanes per block of ``tile`` threads: one warp per lane."""
    return tile // 32


def _check_geometry(fused: FusedFiremaker, tile: int, hidden: int = 0):
    """Refuse, before any launch, a board past the kernels' ``_MAX_HW``
    cells or a block past the card's shared memory (``ValueError``)."""
    if fused.HW > _MAX_HW:
        raise ValueError(
            f"board of {fused.HW} cells: the kernels take at most {_MAX_HW}"
        )
    if _smem_bytes(fused, tile, hidden) > _MAX_SMEM:
        raise ValueError(
            f"hidden {hidden} at tile {tile} does not fit the kernels' "
            "shared memory"
        )


def _check_launch(fused, S, n_steps, tile, hidden=0):
    """The checks both kernels share; returns ``(device, B, n_steps)``."""
    device = S["t"].device
    if device.type != "cuda":
        raise NotImplementedError(f"no firemaker kernel for {device}")
    if fused._mxu_stencil:
        raise NotImplementedError(
            "the CUDA kernels implement the product-form stencil only; "
            "build FusedFiremaker(env, mxu_stencil=False)"
        )
    _check_geometry(fused, tile, hidden)
    B, n_steps = check_kernel_state(
        fused, S, n_steps, tile, max(fused.HW, fused.n * fused.D, fused.n * 5)
    )
    if not (1 <= fused.n <= _MAX_N and fused.D <= _MAX_D):
        raise ValueError(
            f"the kernels take 1..{_MAX_N} agents and at most {_MAX_D} "
            "reward dims"
        )
    return device, B, n_steps


def _set_state(p, fused, S, out):
    for name in fused.STATE_FIELDS:
        setattr(p.inp, name, S[name].data_ptr())
        setattr(p.out, name, out[name].data_ptr())


def fused_firemaker_rollout(fused: FusedFiremaker, S: dict, n_steps: int,
                            tile: int = FusedFiremaker.DEFAULT_TILE,
                            statics=None) -> dict:
    """Advance a packed CUDA state ``n_steps`` steps with one launch of K1
    (``csrc/fused_firemaker.cu``); returns a new state dict. The policy
    installed by ``set_policies`` at the time of the call picks the
    actions (K1's linear branch); without one the draws are uniform.
    ``tile`` is threads per block, a multiple of 32 in [32, 256]: one warp
    per lane, so ``tile // 32`` lanes per block. ``statics`` (firemaker has
    no layouts: the policy) as for :meth:`FusedMaBase.rollout`.

    Checks every field's device, dtype, shape and contiguity, and the
    board and shared memory against the kernel's limits, and raises on what
    the kernel does not take; CPU tensors take the plain version."""
    if S["t"].device.type == "cpu":
        return fused.rollout_plain(S, n_steps, statics)
    device, B, n_steps = _check_launch(fused, S, n_steps, tile)
    if statics is None:
        statics = fused._all_statics(device)
    fused._check_statics_batch(statics, B)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    if n_steps == 0:
        for k in out:
            out[k].copy_(S[k])
        return out
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _firemaker_lib()
    p = _FmParams.from_buffer_copy(fused._kernel_static(device))
    _set_state(p, fused, S, out)
    if "pol_w" in statics:
        for k in POLICY_KEYS:
            setattr(p, k, statics[k].data_ptr())
        p.pol_lanes = statics["pol_w"].shape[1]
    p.B, p.n_steps = B, n_steps
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_firemaker_rollout(
            ctypes.byref(p), fused.n, int(tile), stream
        )
    fused_firemaker_rollout.launches += 1
    _cuda.check(lib, err, "fused_firemaker_rollout launch")
    return out


fused_firemaker_rollout.launches = 0


def fused_firemaker_collect(fused: FusedFiremaker, S: dict, params: dict,
                            n_steps: int,
                            tile: int = FusedFiremaker.DEFAULT_TILE,
                            statics=None):
    """The PPO collection: ``n_steps`` steps under the MLP policy
    ``params`` with one launch of K3 (``csrc/fused_firemaker.cu``).

    Returns ``(S, traj, boot)`` as :meth:`FusedMaBase.rollout_collect`:
    ``traj[name]`` is ``[n_steps, rows, B]``, ``boot`` is ``[n, B]``.
    ``tile`` is threads per block, as for K1. Checks the state as K1 does
    and each MLP tensor's device, dtype, shape and contiguity (``mlp_w1``
    [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1, H], ``mlp_b2`` [A+1, 1],
    float32 on the state's device), and the weights and hidden units
    against the shared memory; CPU tensors take the plain version. K3 reads
    no statics (the MLP picks every action): ``statics`` reaches the plain
    version only."""
    if S["t"].device.type == "cpu":
        return fused.rollout_collect_plain(S, params, n_steps, statics)
    A = fused.amax - fused.amin + 1
    if A > _MAX_A:
        raise ValueError(f"K3 takes at most {_MAX_A} actions, got {A}")
    H = check_mlp_params(fused, params, S["t"].device)
    device, B, n_steps = _check_launch(fused, S, n_steps, tile, H)
    out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
    traj = {
        name: torch.empty((n_steps, rows, B), dtype=dtype, device=device)
        for name, rows, dtype in fused._traj_layout()
    }
    boot = torch.empty((fused.n, B), dtype=_F32, device=device)
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _firemaker_lib()
    p = _FmParams.from_buffer_copy(fused._kernel_static(device))
    _set_state(p, fused, S, out)
    for k in MLP_KEYS:
        setattr(p, k, params[k].data_ptr())
    for name in traj:
        setattr(p.traj, name, traj[name].data_ptr())
    p.traj.boot = boot.data_ptr()
    p.B, p.n_steps, p.hidden = B, n_steps, H
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_firemaker_collect(
            ctypes.byref(p), fused.n, int(tile), stream
        )
    fused_firemaker_collect.launches += 1
    _cuda.check(lib, err, "fused_firemaker_collect launch")
    return out, traj, boot


fused_firemaker_collect.launches = 0
