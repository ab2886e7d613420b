"""The generic chains of the scalar envs that push things against the JAX
package on the CPU: side_effects_sokoban (boxes, coins and the wall
penalty's refund) at every level, conveyor_belt in its four variants and
its MO variant conveyor_belt_ex (the object pushed by the scalar action
order, the belt, the end event) and rocks_diamonds (lumps, switches) at
both levels. The harness is ``test_torch_generic_scalar.py``'s; every
value compared is an integer, a bool or a float32 sum of small integers:
tolerance 0.
"""

import pytest

from test_torch_generic_scalar import (
    _ids,
    check_reset_and_step,
    check_rollout,
)
from torch_threads import one_torch_thread  # noqa: F401

CASES = [
    ("side_effects_sokoban", {"level": 0}),
    ("side_effects_sokoban", {"level": 1}),
    ("side_effects_sokoban", {"level": 2, "noops": True}),
    ("side_effects_sokoban", {"level": 3}),
    ("conveyor_belt_vase", {}),
    ("conveyor_belt_sushi", {}),
    ("conveyor_belt_sushi_goal", {"noops": True}),
    ("conveyor_belt_sushi_goal2", {}),
    ("conveyor_belt_ex", {}),
    ("conveyor_belt_ex", {"variant": "sushi_goal", "noops": True}),
    ("rocks_diamonds", {}),
    ("rocks_diamonds", {"level": 1}),
]
# The configurations chip_smoke.py runs, and sokoban's level 3.
ROLLOUTS = [CASES[i] for i in (0, 1, 3, 4, 7, 8, 10)]


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_reset_step_observe_equal_jax(name, kw):
    check_reset_and_step(name, kw)


@pytest.mark.parametrize("name,kw", ROLLOUTS, ids=_ids(ROLLOUTS))
def test_rollout_equals_jitted_jax(name, kw):
    check_rollout(name, kw)
