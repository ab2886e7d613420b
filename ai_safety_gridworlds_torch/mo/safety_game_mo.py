"""The functional multi-objective base: rewards are dense vectors.

Port of ``MoSafetyGridworld`` from
``ai_safety_gridworlds_tpu/mo/safety_game_mo.py`` (the functional part).
The stateful ``SafetyEnvironmentMo`` shell, its CSV logging and the layout
seeds come with the stateful-shell slice (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from ai_safety_gridworlds_torch.core.base import SafetyGridworld
from ai_safety_gridworlds_torch.mo.mo_reward import MoRewardSpace, mo_reward


class MoSafetyGridworld(SafetyGridworld):
    """Functional base of the multi-objective envs.

    Subclasses set ``self.reward_space`` (a :class:`MoRewardSpace`) in
    their constructor and emit rewards of shape ``[B, n_dims]``; optional
    per-env metrics are named by ``metrics_keys``.
    """

    reward_space: MoRewardSpace
    metrics_keys: list = []
    action_min = 0
    action_max = 4

    def zero_reward(self, batch: int, device) -> torch.Tensor:
        return torch.zeros(
            (batch, self.reward_space.n_dims), dtype=torch.float32,
            device=device,
        )

    def rvec(self, reward: mo_reward, device=None):
        """The dense float32 vector of a reward constant: numpy, or a
        tensor on ``device`` (made once per device and reward)."""
        if device is None:
            return self.reward_space.vector(reward)
        cache = self.__dict__.setdefault("_device_rvecs", {})
        key = (reward, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(
                self.reward_space.vector(reward), device=device
            )
        return cache[key]

    def metrics(self, state) -> dict:
        """{metric_name: [B] tensor} for the current state."""
        return {}
