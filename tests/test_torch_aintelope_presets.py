"""The port's aintelope presets (``experiments/aintelope_presets.py``)
against the JAX package's: the 12 names, each preset's flag table (the
``mo_reward`` values by their dimension dicts), the functional envs, and
one short seeded episode of each through ``make_aintelope_experiment``
against JAX's, on the CPU, exactly (the harness of
``test_torch_moma_shell.py``)."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.experiments import aintelope_presets as jpre
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.experiments import aintelope_presets as tpre
from ai_safety_gridworlds_torch.mo import map_randomization as tmr
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from ai_safety_gridworlds_torch.mo.mo_reward import mo_reward
from test_torch_moma_shell import (  # noqa: F401
    fresh_statics,
    run_moma,
    spec_view,
)
from test_torch_safety_env import assert_same

NAMES = jpre.aintelope_experiment_names()


def plain(value):
    """A flag value with a reward constant as its dimension dict."""
    if isinstance(value, mo_reward) or hasattr(
            value, "_reward_dimensions_dict"):
        return ("mo_reward", dict(value._reward_dimensions_dict))
    return value


def test_names_equal_jax():
    assert tpre.aintelope_experiment_names() == NAMES
    assert len(NAMES) == 12


@pytest.mark.parametrize("name", NAMES)
def test_preset_table_equals_jax(name):
    jcfg, tcfg = jpre.AINTELOPE_EXPERIMENTS[name], \
        tpre.AINTELOPE_EXPERIMENTS[name]
    assert list(tcfg) == list(jcfg)
    for k in jcfg:
        assert plain(tcfg[k]) == plain(jcfg[k]), (name, k)
        assert type(tcfg[k]).__name__ == type(jcfg[k]).__name__, (name, k)
    # The functional envs take the same flags and reward spaces.
    jenv = jpre.make_aintelope_experiment_raw(name)
    tenv = tpre.make_aintelope_experiment_raw(name, max_iterations=3)
    assert tenv.reward_space.keys == jenv.reward_space.keys
    assert tenv.metrics_keys == jenv.metrics_keys
    assert tenv.cfg["max_iterations"] == 3


@pytest.mark.parametrize("name", NAMES)
def test_preset_episode_equals_jax(name):
    traces = []
    for pre, mo, mr, extra in ((jpre, jmo, jmr, {}),
                               (tpre, tmo, tmr, {"device": "cpu"})):
        mo.reset_class_statics()
        mr.clear_randomization_cache()
        env = pre.make_aintelope_experiment(name, seed=4, max_iterations=7,
                                            **extra)
        trace, _ = run_moma(env, 4, episodes=1, max_steps=7)
        traces.append((trace, spec_view(env.observation_spec()),
                       spec_view(env.action_spec())))
    assert_same(*traces)
    assert traces[1][0][-1][0] is not None  # the episode ended


def test_unknown_preset_raises():
    with pytest.raises(NotImplementedError):
        tpre.make_aintelope_experiment("no_such_preset", device="cpu")
    with pytest.raises(NotImplementedError):
        tpre.make_aintelope_experiment_raw("no_such_preset")
    # Env flags that the savanna does not know raise, as JAX's.
    with pytest.raises(TypeError):
        tpre.make_aintelope_experiment_raw("food_sharing", bogus_flag=1)
    np.testing.assert_equal(
        sorted(tpre.AINTELOPE_EXPERIMENTS), sorted(NAMES))
