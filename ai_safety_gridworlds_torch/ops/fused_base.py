"""Shared scaffolding of the fused multi-agent step kernels.

Port of the parts of ``ai_safety_gridworlds_tpu/ops/fused_base.py`` that the
uniform-policy rollout runs: the action-draw and Fisher-Yates agent-order
prologue, the finalize epilogue and the rollout driver. State is a dict of
``[rows, B]`` tensors with the JAX package's field names and dtypes.

``rollout`` goes through the subclass's kernel wrapper
(``_rollout_kernel``), which dispatches on the device of the state: for CPU
tensors it loops the plain PyTorch step body (``_step``); for CUDA tensors
it launches the hand-written kernel and never falls back to the plain body.
``rollout_plain`` runs the plain body on any device; it is what the tests
and the on-card comparison hold the kernel against.

Subclasses implement ``_step(S, collect_draws)``, ``_rollout_kernel(S,
n_steps, tile)`` and ``init_packed(seed, batch, device)``, and declare
``STATE_FIELDS`` and ``DEFAULT_TILE``.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_torch.ops import prng

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)
NONE = int(TerminationReason.NONE)


def min_water_dist(water_b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Per-lane min-Manhattan distance to water, clamped to 99.

    ``water_b`` is bool [HW, B]; returns int32 [HW, B] (99 for lanes
    without water). Vectorized over 256-lane chunks."""
    HW, B = water_b.shape
    cells = np.arange(HW, dtype=np.int32)
    rr, cc = cells // w, cells % w
    d2 = (
        np.abs(rr[:, None] - rr[None, :]) + np.abs(cc[:, None] - cc[None, :])
    ).astype(np.int32)  # [HW, HW]
    dist = np.empty((HW, B), np.int32)
    for s in range(0, B, 256):
        dd = np.where(water_b[None, :, s : s + 256], d2[:, :, None], 9999)
        m = dd.min(axis=1)
        dist[:, s : s + 256] = np.where(m > 98, 99, m)
    return dist


class FusedMaBase:
    """Packed batched MA env with a single-kernel rollout."""

    STATE_FIELDS: tuple = ()
    DEFAULT_TILE: int

    # ------------------------------------------------------------ prologue

    def _draw_actions_and_order(self, S, over, reasons, ctr0, iota_n):
        """Uniform per-agent action draws (site 0) and the Fisher-Yates
        agent order (site 1). Reset lanes and dead agents draw -1.

        Returns ``(actions, order)``, both int32 [n, B]."""
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        n = iota_n.shape[0]
        u_act = prng.uniform(key_hi, key_lo, ctr0, iota_n)
        actions = self.amin + torch.floor(
            u_act * (self.amax - self.amin + 1)
        ).to(torch.int32)
        actions = actions.clamp(self.amin, self.amax)
        actions = torch.where(over | (reasons != NONE), -1, actions)

        order = iota_n.expand(n, actions.shape[1]).clone()
        if getattr(self.env, "randomize_agent_actions_order", False) and n > 1:
            u_perm = prng.uniform(key_hi, key_lo, ctr0 + 1, iota_n)
            for k in range(n - 1, 0, -1):
                jidx = torch.floor(u_perm[k : k + 1] * (k + 1)).to(
                    torch.int32
                ).clamp(0, k)
                vk = order[k : k + 1]
                vj = order.gather(0, jidx.long())
                order = torch.where(iota_n == jidx, vk, order)
                order = torch.where(iota_n == k, vj, order)
        return actions, order

    # ------------------------------------------------------------ epilogue

    def _finalize_types(self, t, reasons, types, over):
        """Per-agent step-type transitions and the episode-done flag."""
        truncated = t >= self.max_iterations
        game_over_pa = truncated | (reasons != NONE)
        ended = torch.where(
            (types == MID) | (types == FIRST),
            torch.full_like(types, LAST), torch.full_like(types, DEAD),
        )
        new_types = torch.where(game_over_pa, ended, MID)
        out_types = torch.where(over, FIRST, new_types)
        done = game_over_pa.all(dim=0, keepdim=True) & ~over
        return out_types, done

    # ------------------------------------------------------------ drivers

    def step(self, S, collect_draws=False):
        """One plain packed step on any device (the plain version of the
        kernel's step body, for tests and interop)."""
        return self._step(S, collect_draws=collect_draws)

    def rollout_plain(self, S, n_steps):
        """``n_steps`` plain steps on any device."""
        for _ in range(n_steps):
            S = self._step(S)
        return S

    def rollout(self, S, n_steps, tile=None):
        """Advance the packed batch ``n_steps`` full MA steps through the
        kernel's wrapper: CPU tensors take the plain PyTorch step body;
        CUDA tensors launch the hand-written kernel, one launch per call.
        Cumulative reward sums and episode counts accumulate in
        ``stats_rewards`` / ``stats_episodes``."""
        return self._rollout_kernel(
            S, n_steps, self.DEFAULT_TILE if tile is None else tile
        )
