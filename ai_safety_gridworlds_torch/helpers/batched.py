"""One-call batched rollouts behind the fused kernel, or the generic path.

Port of ``ai_safety_gridworlds_tpu/helpers/batched.py``:
``BatchedEnv(name, batch_size, device=...)`` resolves the registered env,
asks :func:`ai_safety_gridworlds_torch.ops.make_fused` for its fused driver
and packs ``batch_size`` auto-resetting lanes on ``device``. On a CUDA
device every fused ``rollout`` is one launch of the hand-written kernel
(``kernel == "fused_cuda"``); on the CPU it runs the plain PyTorch version
(``kernel == "fused_torch"``).

``backend="generic"``, and ``"auto"`` when no kernel takes the
configuration (``make_fused`` gives ``None`` or ``init_packed`` refuses
it, on a CUDA device also for the limits the island_navigation_ex_ma and
aintelope_savanna kernels have whatever the state; logged as a warning),
run the generic batched path instead: ``core.base.rollout`` or
``ma.safety_game_ma.ma_rollout`` in plain PyTorch on ``device``
(``kernel == "generic_torch"``), with the per-env chains of all 18
registered envs: the scalar boat_race, island_navigation, boat_race_ex,
island_navigation_ex, absent_supervisor, distributional_shift,
safe_interruptibility, safe_interruptibility_ex, side_effects_sokoban,
whisky_gold (``human_player=True``, which no fused kernel takes, runs only
here), tomato_watering, tomato_crmdp, conveyor_belt (and its
``conveyor_belt_{variant}`` names), rocks_diamonds, friend_foe and
conveyor_belt_ex, and the multi-agent firemaker_ex_ma,
island_navigation_ex_ma and aintelope_savanna (a savanna top-up beyond the
free cells, which its kernel refuses, runs here). The generic path is
eager PyTorch, hundreds of small launches a step, and much slower than
the fused kernels. Nothing falls back to the CPU: asking for
``device="cuda"`` without a CUDA device raises, and ``backend="fused"``
never falls back.
"""

from __future__ import annotations

import logging
from typing import Optional


class BatchedEnv:
    """A batch of auto-resetting environments behind the fused kernel or
    the generic path.

    ``BatchedEnv("firemaker_ex_ma", 4096).rollout(256)`` steps a uniform
    random policy on every lane and returns per-call statistics; ``kernel``
    says which path runs.
    """

    def __init__(
        self,
        name: str,
        batch_size: int = 1024,
        *,
        seed: int = 0,
        backend: str = "auto",
        tile: Optional[int] = None,
        device="cuda",
        **env_kwargs,
    ):
        if backend not in ("auto", "fused", "generic"):
            raise ValueError(
                f"backend must be auto|fused|generic, got {backend!r}"
            )
        from ai_safety_gridworlds_torch import ops
        from ai_safety_gridworlds_torch.helpers import factory

        self.device = ops.resolve_device(device)
        self.name = name
        self.batch_size = batch_size
        self.seed = seed
        self.tile = tile
        self.env = factory.get_raw_env(name, **env_kwargs)
        self._fused = None
        if backend != "generic":
            self._fused = ops.make_fused(self.env)
        if backend == "fused" and self._fused is None:
            raise NotImplementedError(
                f"{name!r} has no fused kernel for this configuration"
            )
        if self._fused is not None:
            try:
                # The packer tests its kernel's static limits at the
                # launches' tile on a CUDA device.
                self._S = self._fused.init_packed(
                    seed, batch_size, self.device, tile=tile
                )
            except (ValueError, NotImplementedError):
                # A kernel exists for the env but its packer refuses this
                # configuration (the layout, top-up and static-limit checks
                # raise these); on "auto" fall back loudly. Any other
                # error, a CUDA one included, reaches the caller.
                if backend == "fused":
                    raise
                logging.getLogger(__name__).warning(
                    "fused kernel for %r rejected this configuration at "
                    "init_packed; falling back to the generic path (much "
                    "slower)", name, exc_info=True,
                )
                self._fused = None
        if self._fused is not None:
            self._eps0 = 0
            self._rew0 = self._reward_sums()
        else:
            from ai_safety_gridworlds_torch.core import threefry

            self._key = threefry.PRNGKey(seed, self.device)
        self._is_ma = hasattr(self.env, "n_agents")

    @property
    def kernel(self) -> str:
        if self._fused is None:
            return "generic_torch"
        return "fused_cuda" if self.device.type == "cuda" else "fused_torch"

    @property
    def state(self) -> dict:
        """The packed kernel state (dict of ``[rows, B]`` tensors)."""
        if self._fused is None:
            raise AttributeError(
                "generic path keeps no persistent packed state"
            )
        return self._S

    @property
    def fused(self):
        """The fused kernel driver, or None on the generic path."""
        return self._fused

    def _reward_sums(self):
        # The JAX package's sums: numpy's float32 sum of the per-lane
        # float32 totals.
        return self._S["stats_rewards"].cpu().numpy().sum(axis=-1)

    def rollout(self, n_steps: int) -> dict:
        """Advance every lane ``n_steps`` env steps under a uniform-random
        policy and return PER-CALL aggregate statistics: ``episodes``
        finished during this call, ``sum_rewards``, ``steps``
        (``n_steps * batch_size``) and ``kernel``. On the fused path
        ``sum_rewards`` sums the observed rewards of all lanes this call
        (one per agent and reward dimension); on the generic path it sums
        the final returns of the episodes that finished, and every call
        starts fresh episodes from the next key, as JAX's generic path."""
        if self._fused is not None:
            self._S = self._fused.rollout(self._S, n_steps, tile=self.tile)
            # The kernel's stats_* accumulate since init; report deltas so
            # repeated calls do not double-count.
            eps = int(self._S["stats_episodes"].sum())
            rew = self._reward_sums()
            stats = {
                "episodes": eps - self._eps0, "sum_rewards": rew - self._rew0,
            }
            self._eps0, self._rew0 = eps, rew
        else:
            from ai_safety_gridworlds_torch.core import threefry

            k = threefry.split(self._key)
            self._key, sub = k[0], k[1]
            if self._is_ma:
                from ai_safety_gridworlds_torch.ma.safety_game_ma import (
                    ma_rollout,
                )

                _, raw = ma_rollout(
                    self.env, sub, n_steps, self.batch_size,
                    device=self.device,
                )
                rewards = raw["sum_final_returns"]
            else:
                from ai_safety_gridworlds_torch.core.base import rollout

                _, raw = rollout(
                    self.env, sub, n_steps, self.batch_size,
                    device=self.device,
                )
                rewards = raw["sum_final_return"]
            stats = {
                "episodes": int(raw["episodes"]),
                "sum_rewards": rewards.cpu().numpy(),
            }
        stats["steps"] = n_steps * self.batch_size
        stats["kernel"] = self.kernel
        return stats


def batched_rollout(
    name: str,
    batch_size: int = 1024,
    n_steps: int = 256,
    *,
    seed: int = 0,
    backend: str = "auto",
    tile: Optional[int] = None,
    device="cuda",
    **env_kwargs,
) -> dict:
    """One-call batched rollout for a registered env name."""
    return BatchedEnv(
        name, batch_size, seed=seed, backend=backend, tile=tile,
        device=device, **env_kwargs,
    ).rollout(n_steps)
