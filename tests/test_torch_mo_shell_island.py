"""island_navigation_ex's ten levels through the port's MO shell against
the JAX package's, on the CPU (``tests/test_torch_mo_shell.py``'s harness
and rules: everything equal, exactly). The shell's step takes drink and
food regrowth from ``host_step_options`` (float64 ``math.pow`` on the
host, as the reference), so the fractions are equal too, with no
exemption; the metrics (satiations, availabilities, visits) are compared
in the observation's ``metrics_dict`` and ``metrics_matrix`` each step."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.envs import island_navigation_ex as jisl
from ai_safety_gridworlds_torch.envs import island_navigation_ex as tisl
from test_torch_mo_shell import check_mo_against_jax, fresh_statics  # noqa: F401
from test_torch_safety_env import assert_same


@pytest.mark.parametrize("level", range(10))
def test_island_navigation_ex_equals_jax(level):
    check_mo_against_jax("island_navigation_ex", {"level": level})


def test_island_navigation_ex_scalarised_equals_jax():
    check_mo_against_jax("island_navigation_ex",
                         {"level": 7, "thirst_hunger_death": True},
                         scalarise=True)


@pytest.mark.parametrize("kw", [{"level": 2}, {"level": 6},
                                {"level": 8, "sustainability_challenge": False},
                                {"level": 9, "FOOD_GROWTH_LIMIT": 12}])
def test_host_step_options_equal_jax(kw):
    """The hook's availabilities and fractions from the same states (every
    action, QUIT included, from states along a random walk)."""
    jgame, tgame = jisl.IslandNavigationEx(**kw), tisl.IslandNavigationEx(**kw)
    from ai_safety_gridworlds_tpu.mo.safety_game_mo import (
        SafetyEnvironmentMo as J,
    )
    from ai_safety_gridworlds_torch.mo.safety_game_mo import (
        SafetyEnvironmentMo as T,
    )

    jenv, tenv = J(jgame, seed=2), T(tgame, seed=2, device="cpu")
    jenv.reset()
    tenv.reset()
    act = np.random.default_rng(3)
    for _ in range(60):
        for a in (0, 1, 2, 3, 4, 9):
            assert_same(jgame.host_step_options(jenv._state, a),
                        tgame.host_step_options(tenv._state, a))
        assert_same(jgame.host_extras(jenv._state),
                    tgame.host_extras(tenv._state))
        a = int(act.integers(0, 5))
        if jenv.step(a).last():
            jenv.reset()
        if tenv.step(a).last():
            tenv.reset()


def test_observation_views_equal_jax():
    """``calculate_observation_coordinates``, ``get_layers_order`` and
    ``calculate_observation_layers_cube`` on the host observations, with
    and without occlusion (the same refusals where the reference's code
    refuses)."""
    from ai_safety_gridworlds_tpu.mo.safety_game_mo import (
        SafetyEnvironmentMo as J,
    )
    from ai_safety_gridworlds_torch.mo.safety_game_mo import (
        SafetyEnvironmentMo as T,
    )
    from test_torch_mo_helpers import outcome

    jenv = J(jisl.IslandNavigationEx(level=9), seed=3)
    tenv = T(tisl.IslandNavigationEx(level=9), seed=3, device="cpu")
    for a in (None, 2, 4, 1):
        jts, tts = ((env.reset() if a is None else env.step(a))
                    for env in (jenv, tenv))
        jo, to = jts.observation, tts.observation
        for env_obs in ((jenv, jo), (tenv, to)):
            assert "ascii" in env_obs[1]
        for occlusion in (False, True):
            for ascii_ in (False, True):
                assert_same(
                    outcome(lambda: jenv.calculate_observation_coordinates(
                        jo, occlusion, ascii_, {"A": (1, 1)})),
                    outcome(lambda: tenv.calculate_observation_coordinates(
                        to, occlusion, ascii_, {"A": (1, 1)})))
            for order in ([], ["W", "A", " "]):
                assert_same(
                    outcome(lambda: jenv.get_layers_order(jo, occlusion,
                                                          order)),
                    outcome(lambda: tenv.get_layers_order(to, occlusion,
                                                          order)))
                j = outcome(lambda: jenv.calculate_observation_layers_cube(
                    jo, occlusion, order))
                t = outcome(lambda: tenv.calculate_observation_layers_cube(
                    to, occlusion, order))
                assert j[0] == t[0]
                if j[0] == "ok":
                    assert_same(np.asarray(j[1]), np.asarray(t[1]))
