"""One-call batched rollouts behind the fused kernel.

Port of ``ai_safety_gridworlds_tpu/helpers/batched.py``:
``BatchedEnv(name, batch_size, device=...)`` resolves the registered env,
asks :func:`ai_safety_gridworlds_torch.ops.make_fused` for its fused driver
(firemaker_ex_ma, island_navigation_ex_ma, aintelope_savanna and every
scalar env: each name the JAX ``make_fused`` routes; any other name raises
``NotImplementedError``) and packs ``batch_size`` auto-resetting lanes on
``device``. On a CUDA
device every ``rollout`` is one launch of the hand-written kernel
(``kernel == "fused_cuda"``); on the CPU it runs the plain PyTorch version
(``kernel == "fused_torch"``). Nothing falls back to the CPU: asking for
``device="cuda"`` without a CUDA device raises.

The generic vmapped path of the JAX package (``backend="generic"``) is not
ported yet (``ROADMAP.md``, Queue A item 4) and raises.
"""

from __future__ import annotations

from typing import Optional


class BatchedEnv:
    """A batch of auto-resetting environments behind the fused kernel.

    ``BatchedEnv("firemaker_ex_ma", 4096).rollout(256)`` steps a uniform
    random policy on every lane and returns per-call statistics.

    ``backend`` mirrors the JAX signature and has no effect yet: ``"auto"``
    and ``"fused"`` both select the fused path, the only one ported, and
    ``"generic"`` raises until the generic path is ported.
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
        if backend == "generic":
            raise NotImplementedError(
                "the generic batched path is not ported yet, see ROADMAP.md"
            )
        from ai_safety_gridworlds_torch import ops

        self.device = ops.resolve_device(device)
        from ai_safety_gridworlds_torch.helpers import factory

        self.name = name
        self.batch_size = batch_size
        self.seed = seed
        self.tile = tile
        self.env = factory.get_raw_env(name, **env_kwargs)
        self._fused = ops.make_fused(self.env)
        self._S = self._fused.init_packed(seed, batch_size, self.device)
        self._eps0 = 0
        self._rew0 = self._reward_sums()

    @property
    def kernel(self) -> str:
        return "fused_cuda" if self.device.type == "cuda" else "fused_torch"

    @property
    def state(self) -> dict:
        """The packed kernel state (dict of ``[rows, B]`` tensors)."""
        return self._S

    @property
    def fused(self):
        """The fused kernel driver."""
        return self._fused

    def _reward_sums(self):
        # The JAX package's sums: numpy's float32 sum of the per-lane
        # float32 totals.
        return self._S["stats_rewards"].cpu().numpy().sum(axis=-1)

    def rollout(self, n_steps: int) -> dict:
        """Advance every lane ``n_steps`` env steps under a uniform-random
        policy and return PER-CALL aggregate statistics: ``episodes``
        finished during this call, ``sum_rewards`` (observed-reward sums
        over all lanes this call, one per agent and reward dimension), ``steps``
        (``n_steps * batch_size``) and ``kernel``."""
        self._S = self._fused.rollout(self._S, n_steps, tile=self.tile)
        # The kernel's stats_* accumulate since init; report deltas so
        # repeated calls do not double-count.
        eps = int(self._S["stats_episodes"].sum())
        rew = self._reward_sums()
        stats = {"episodes": eps - self._eps0, "sum_rewards": rew - self._rew0}
        self._eps0, self._rew0 = eps, rew
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
