"""The port's registry (``helpers/factory.py`` and the package's
``get_environment_obj``) against the JAX package's: the 47 names of
``env_names()``, each built in its stateful shell on the CPU with one
reset (the same shell class and specs as JAX's), the routing of the
shell's keywords and the env's flags, and ``NotImplementedError`` for an
unknown name."""

import numpy as np
import pytest

import ai_safety_gridworlds_tpu as jpkg
import ai_safety_gridworlds_torch as tpkg
from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from test_torch_moma_shell import fresh_statics, spec_view  # noqa: F401
from test_torch_safety_env import assert_same

NAMES = jfactory.env_names()


def test_names_equal_jax():
    assert tfactory.env_names() == NAMES
    assert len(NAMES) == 47
    assert tpkg.environment_names() == jpkg.environment_names()
    assert tpkg.__version__ == jpkg.__version__


@pytest.mark.parametrize("name", NAMES)
def test_each_name_builds_and_resets_on_the_cpu(name):
    env = tpkg.get_environment_obj(name, seed=3, device="cpu")
    jenv = jfactory._registry[name]  # the JAX constructor's shell kind
    jkind = {"_make_scalar": "SafetyEnvironment",
             "_make_mo": "SafetyEnvironmentMo",
             "_make_moma": "SafetyEnvironmentMoMa"}.get(
        jenv.__qualname__.split(".")[0])
    if jkind is not None:
        assert type(env).__name__ == jkind, name
    ts = env.reset()
    assert ts.observation["board"].ndim == 2
    assert isinstance(ts.observation["board"], np.ndarray)
    raw = tfactory.get_raw_env(name)
    assert type(raw).__name__ == type(env._game).__name__


def test_shells_equal_jax_in_kind_and_specs():
    """One name of each shell kind and preset family: the JAX shell's class
    name and observation and action specs."""
    for name in ("boat_race", "island_navigation_ex", "firemaker_ex_ma",
                 "food_drink_bounded", "food_sharing"):
        jenv = jfactory.get_environment_obj(name, seed=3)
        tenv = tfactory.get_environment_obj(name, seed=3, device="cpu")
        assert type(tenv).__name__ == type(jenv).__name__, name
        assert_same(spec_view(jenv.observation_spec()),
                    spec_view(tenv.observation_spec()))
        assert_same(spec_view(jenv.action_spec()),
                    spec_view(tenv.action_spec()))


def test_keywords_route_to_the_shell_or_the_env():
    env = tfactory.get_environment_obj(
        "firemaker_ex_ma", seed=9, device="cpu", reference_csv_format=True,
        log_columns=["iteration"], scalarise=True, max_iterations=7)
    assert env.reference_csv_format and env.scalarise
    assert env.log_columns == ["iteration"]
    assert env._game.max_iterations == 7 and env.get_env_seed() is not None
    env = tfactory.get_environment_obj("boat_race_ex", level=2, seed=1,
                                       device="cpu", gzip_log=True)
    assert env.gzip_log and env._game.level == 2
    env = tfactory.get_environment_obj("boat_race", seed=4, scalarise=True,
                                       device="cpu")
    assert env._seed == 4
    env = tfactory.get_environment_obj("food_sharing", device="cpu",
                                       max_iterations=5, seed=2)
    assert env._game.max_iterations == 5
    with pytest.raises(TypeError):
        tfactory.get_environment_obj("firemaker_ex_ma", device="cpu",
                                     bogus_flag=1)


def test_unknown_name_raises():
    with pytest.raises(NotImplementedError, match="not available"):
        tfactory.get_environment_obj("no_such_env", device="cpu")
    with pytest.raises(NotImplementedError, match="not available"):
        tpkg.get_environment_obj("no_such_env")
    with pytest.raises(NotImplementedError, match="not available"):
        tfactory.get_raw_env("no_such_env")
