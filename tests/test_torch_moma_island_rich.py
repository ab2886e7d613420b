"""The multi-agent shell over island_navigation_ex_ma against the JAX
package's, on the CPU, with the harness of ``test_torch_moma_shell.py``:
sustainability with oversatiation and the proportional rewards, fractional
GAP and NON rewards, the map randomized per episode (the new board applied
on the host, the device tables dropped and made anew from it), and the
agents' perspectives and coordinates. Exact, but for the regrowth under
sustainability (the harness's rule: the traces are compared up to a step
whose regrown power came within 1e-5 of an integer, and such steps are
counted)."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.ma import safety_game_moma as jmoma
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.ma import safety_game_moma as tmoma
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_moma_shell import (  # noqa: F401
    check_moma_against_jax,
    fresh_statics,
    run_moma,
)
from test_torch_safety_env import assert_same
from torch_threads import one_torch_thread  # noqa: F401

SUSTAIN = dict(level=3, sustainability_challenge=True,
               penalise_oversatiation=True,
               use_satiation_proportional_reward=True, max_iterations=25)
FRACTIONAL = dict(level=8, max_iterations=14,
                  GAP_REWARD="{'FOOD_REWARD': 0.5, 'DRINK_REWARD': -0.25}",
                  NON_DRINK_REWARD="{'DRINK_REWARD': -0.5}",
                  NON_FOOD_REWARD="{'FOOD_REWARD': 0.125}")


@pytest.mark.parametrize("kw", [SUSTAIN, FRACTIONAL],
                         ids=["sustain", "fractional"])
def test_island_rewards_equal_jax(kw):
    _, tenv, exempt = check_moma_against_jax(
        "island_navigation_ex_ma", kw, max_steps=25)
    # The rule exempts a step only where a regrown power came within 1e-5
    # of an integer; these seeds meet none.
    assert exempt == 0
    assert tenv.get_overall_performance() is not None


def test_map_randomization_per_episode_equals_jax():
    kw = dict(level=7, map_randomization_frequency=3, max_iterations=8)
    jenv, tenv, exempt = check_moma_against_jax(
        "island_navigation_ex_ma", kw, max_steps=8)
    game = tenv._game
    assert exempt == 0
    assert not getattr(game, "_needs_retrace", False)
    # The last episode's board was drawn anew and reached the device
    # tables from which the chain paints.
    assert not np.array_equal(game._board_now, game._orig_board)
    np.testing.assert_array_equal(game.const("_board_now", "cpu").numpy(),
                                  game._board_now)
    np.testing.assert_array_equal(tenv.last_observation()["ascii_codes"],
                                  jenv.last_observation()["ascii_codes"])


def test_perspectives_and_coordinates_equal_jax():
    """Each agent's rotated 5 x 5 view (observation direction mode 1) and
    the layer coordinates around it, at every step of a short run."""
    out = []
    for shell, raw, extra in (
            (jmoma.SafetyEnvironmentMoMa, jfactory.get_raw_env, {}),
            (tmoma.SafetyEnvironmentMoMa, tfactory.get_raw_env,
             {"device": "cpu"})):
        tmo.reset_class_statics()
        env = shell(raw("island_navigation_ex_ma", level=9), seed=6, **extra)
        rng = np.random.default_rng(4)
        ts = env.reset()
        views = []
        for _ in range(8):
            persp = env.agent_perspectives_with_layers(ts.observation)
            views.append((
                persp,
                env.calculate_agents_observation_coordinates(
                    ts.observation, persp),
                env.agent_perspectives_with_layers(
                    ts.observation, include_layers=False, ascii=False,
                    observe_from_agent_coordinates={"1": (1, 1)},
                    observe_from_agent_directions={"2": 3}),
            ))
            acts = {a: int(rng.integers(0, 5)) for a in env.agent_names
                    if int(ts.step_type[a]) < 2}
            if not acts:
                break
            ts = env.step(acts)
        out.append(views)
    assert_same(*out)
    assert out[1][0][0]["1"]["board"].shape == (5, 5)


def test_run_moma_counts_island_regrowth_gaps():
    """The harness's gap channel sees the regrowth of every sub-step."""
    tmo.reset_class_statics()
    game = tfactory.get_raw_env("island_navigation_ex_ma", **SUSTAIN)
    game.regrow_gaps = []
    env = tmoma.SafetyEnvironmentMoMa(game, seed=5, device="cpu")
    trace, near = run_moma(env, 5, episodes=1, max_steps=10)
    assert len(near) == len(trace)
    assert game.regrow_gaps == []  # drained step by step
