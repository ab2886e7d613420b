"""The experiment presets (``experiments/presets.py``) against the JAX
package's: the names, the tables, and one seeded episode of each preset's
MO shell (``make_experiment(name, seed=...)``) equal, exactly, to JAX's
(``tests/test_torch_mo_shell.py``'s rules); the raw registry knows every
preset."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.experiments import presets as jpresets
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.experiments import presets as tpresets
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_mo_shell import (  # noqa: F401
    assert_mo_specs_equal,
    fresh_statics,
    run_mo,
)
from test_torch_safety_env import assert_same

NAMES = jpresets.experiment_names()


def test_experiment_names_and_tables_equal_jax():
    assert tpresets.experiment_names() == NAMES
    assert len(NAMES) == 12
    for name in NAMES:
        j, t = jpresets.EXPERIMENTS[name], tpresets.EXPERIMENTS[name]
        assert list(j) == list(t), name
        for k in j:
            jv, tv = j[k], t[k]
            if hasattr(jv, "_dims"):
                assert jv._dims == tv._dims, (name, k)
            else:
                assert jv == tv and type(jv) is type(tv), (name, k)
    with pytest.raises(NotImplementedError):
        tpresets.make_experiment("no_such_experiment", device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_preset_episode_equals_jax(name):
    jmo.reset_class_statics()
    jenv = jpresets.make_experiment(name, seed=4)
    jtrace = run_mo(jenv, 4, episodes=1, resets=False)
    tmo.reset_class_statics()
    tenv = tpresets.make_experiment(name, seed=4, device="cpu")
    ttrace = run_mo(tenv, 4, episodes=1, resets=False)
    assert_same(jtrace, ttrace)
    assert_mo_specs_equal(jenv, tenv)
    assert tenv.get_overall_performance() is not None
    raw = tfactory.get_raw_env(name)
    assert raw.cfg == tenv._game.cfg


def test_preset_overrides_reach_env_and_shell():
    env = tpresets.make_experiment("food_drink_bounded_gold", seed=1,
                                   max_iterations=7, scalarise=True,
                                   device="cpu")
    assert env._game.max_iterations == 7 and env.scalarise
    ts = env.reset()
    while not ts.last():
        ts = env.step(0)
    assert int(env._state.t[0]) == 7
    assert isinstance(ts.reward, np.float64)
