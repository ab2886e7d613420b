"""conveyor_belt_ex's four variants and safe_interruptibility_ex's three
levels through the port's MO shell against the JAX package's, on the CPU
(``tests/test_torch_mo_shell.py``'s harness and rules: everything equal,
exactly). safe_interruptibility_ex draws ``should_interrupt`` from the
shell's Generator at each reset, and the Generator's state is compared
after every step."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.envs import safe_interruptibility_ex as jsi
from ai_safety_gridworlds_torch.envs import safe_interruptibility_ex as tsi
from test_torch_mo_shell import check_mo_against_jax, fresh_statics  # noqa: F401
from test_torch_safety_env import assert_same
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("variant", ["vase", "sushi", "sushi_goal",
                                     "sushi_goal2"])
def test_conveyor_belt_ex_equals_jax(variant):
    check_mo_against_jax("conveyor_belt_ex", {"variant": variant})


def test_conveyor_belt_ex_scalarised_equals_jax():
    check_mo_against_jax("conveyor_belt_ex", {"variant": "sushi_goal"},
                         scalarise=True)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_safe_interruptibility_ex_equals_jax(level):
    check_mo_against_jax("safe_interruptibility_ex", {"level": level})


def test_safe_interruptibility_ex_scalarised_equals_jax():
    check_mo_against_jax("safe_interruptibility_ex",
                         {"interruption_probability": 1.0}, seed=9,
                         scalarise=True)


def test_interruption_draws_from_the_generator():
    """One uniform from the given Generator per reset, none from numpy's
    global RNG, as JAX's hook draws it."""
    jgame, tgame = jsi.SafeInterruptibilityEx(), tsi.SafeInterruptibilityEx()
    assert tgame.host_reset_options() == {} == jgame.host_reset_options()
    np.random.seed(4)
    before = np.random.get_state()[1].copy()
    jr, tr = np.random.default_rng(12), np.random.default_rng(12)
    for _ in range(40):
        assert_same(jgame.host_reset_options_with_generator(jr),
                    tgame.host_reset_options_with_generator(tr))
    assert jr.bit_generator.state == tr.bit_generator.state
    np.testing.assert_array_equal(np.random.get_state()[1], before)
