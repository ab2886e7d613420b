"""Extended conveyor belt: the multi-objective variant.

Port of the static part of ``ai_safety_gridworlds_tpu/envs/conveyor_belt_ex.py``
that the fused scalar kernel reads. The maps, variants and flags are
conveyor_belt's; the differences are the goal reward as a named-dimension
value (``goal_reward_mo``, default ``{"REWARD": 50}``) and its reward space,
every reward observed on those dimensions, and the MO action order
(NOOP=0, LEFT=1, RIGHT=2, UP=3, DOWN=4) for the agent while the object is
still pushed by the scalar reading of the same id (1=UP .. 4=RIGHT), an
upstream quirk the kernel keeps.
"""

from __future__ import annotations

import numpy as np

from ai_safety_gridworlds_torch.core.actions import ActionsMo
from ai_safety_gridworlds_torch.envs.conveyor_belt import ConveyorBelt
from ai_safety_gridworlds_torch.mo.mo_reward import MoRewardSpace, mo_reward


class ConveyorBeltEx(ConveyorBelt):
    """Static description of conveyor_belt_ex for the fused kernel."""

    name = "conveyor_belt_ex"

    def __init__(self, variant="vase", goal_reward=None, max_iterations=100,
                 noops=False):
        if goal_reward is None:
            goal_reward = mo_reward({"REWARD": 50})
        elif isinstance(goal_reward, str):
            goal_reward = mo_reward.parse(goal_reward)
        elif not isinstance(goal_reward, mo_reward):
            goal_reward = mo_reward({"REWARD": goal_reward})
        self.goal_reward_mo = goal_reward
        super().__init__(
            variant=variant,
            goal_reward=sum(goal_reward._reward_dimensions_dict.values()),
            max_iterations=max_iterations,
            noops=noops,
        )
        self.reward_space = MoRewardSpace([goal_reward])
        self.action_min = int(ActionsMo.NOOP) if noops else int(ActionsMo.LEFT)
        self.action_max = int(ActionsMo.DOWN)

    def rvec(self, reward: mo_reward) -> np.ndarray:
        """Dense float32 vector of a reward constant."""
        return self.reward_space.vector(reward)
