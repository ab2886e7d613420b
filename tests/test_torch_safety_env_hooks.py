"""The rest of the stateful shell's configurations against the JAX
package's ``SafetyEnvironment`` (``tests/test_torch_safety_env.py``'s
rules: everything equal, exactly), the envs' host hooks on their own, and
friend_foe's cross-run persistence of its bandit estimates."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.envs import friend_foe as jff
from ai_safety_gridworlds_tpu.envs.tomato_watering import (
    TomatoWatering as JTomato,
)
from ai_safety_gridworlds_tpu.helpers.safety_env import (
    SafetyEnvironment as JShell,
)
from ai_safety_gridworlds_torch.envs import friend_foe as tff
from ai_safety_gridworlds_torch.envs.tomato_watering import (
    TomatoWatering as TTomato,
)
from ai_safety_gridworlds_torch.helpers.safety_env import (
    SafetyEnvironment as TShell,
)
from test_torch_safety_env import assert_same, check_against_jax, run_shell
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,kw", [
    ("safe_interruptibility", {"level": 0, "interruption_probability": 1.0}),
    ("tomato_watering", {}),
    ("tomato_crmdp", {}),
    ("rocks_diamonds", {}),
    ("friend_foe", {}),
    ("friend_foe", {"bandit_type": "adversary", "extra_step": True}),
    ("conveyor_belt", {}),
    ("conveyor_belt_vase", {}),
    ("conveyor_belt_sushi", {}),
    ("conveyor_belt_sushi_goal", {}),
    ("conveyor_belt_sushi_goal2", {}),
])
def test_shell_equals_jax(name, kw):
    check_against_jax(name, kw)


def test_tomato_host_step_draws_follow_the_move():
    """One ``np.random.random()`` per watered tomato after the pending
    move, as JAX's hook draws them, from the same state."""
    np.random.seed(1)
    jenv = JShell(JTomato(), seed=1)
    np.random.seed(1)
    tenv = TShell(TTomato(), seed=1, device="cpu")
    state = np.random.get_state()
    jenv.reset()
    np.random.set_state(state)
    tenv.reset()
    act = np.random.default_rng(2)
    for _ in range(30):
        a = int(act.choice([0, 1, 2, 3, 4, 9]))  # NOOP and QUIT included
        state = np.random.get_state()
        want = jenv._game.host_step_options(jenv._state, a)
        np.random.set_state(state)
        got = tenv._game.host_step_options(tenv._state, a)
        np.random.set_state(state)
        assert_same(want, got)
        if a == 9:
            break
        jenv.step(a)
        np.random.set_state(state)
        tenv.step(a)


def test_friend_foe_environment_data_round_trip(tmp_path):
    """Two runs each: the first's bandit estimates saved with
    ``save_environment_data`` and loaded into the second through
    ``load_environment_data``, in both packages alike."""
    files = {"jax": tmp_path / "jax.pkl", "port": tmp_path / "port.pkl"}
    traces = {}
    for side, (mod, Shell, kw) in {
            "jax": (jff, JShell, {}),
            "port": (tff, TShell, {"device": "cpu"})}.items():
        np.random.seed(5)
        env = Shell(mod.FriendFoe(bandit_type="friend"), seed=5, **kw)
        run_shell(env, 5, episodes=4)
        mod.save_environment_data(env.environment_data, files[side])
        loaded = mod.load_environment_data(files[side])
        np.testing.assert_array_equal(loaded["bandit_policies"],
                                      env.environment_data["bandit_policies"])
        np.random.seed(6)
        again = Shell(mod.FriendFoe(environment_data=loaded,
                                    bandit_type="friend"), seed=6, **kw)
        np.testing.assert_array_equal(
            again._game._policies,
            np.asarray(loaded["bandit_policies"], np.float64))
        traces[side] = (loaded, run_shell(again, 6, episodes=2))
    # The estimates moved away from uniform and placed the next box.
    assert (traces["port"][0]["bandit_policies"] != 0.5).any()
    assert_same(traces["jax"], traces["port"])


def test_friend_foe_missing_file_is_memoryless(tmp_path, capsys):
    assert tff.load_environment_data(tmp_path / "absent.pkl") == {}
    assert tff.load_environment_data(None) == {}
    tff.save_environment_data({"bandit_policies": 1}, None)
    assert "Warning" in capsys.readouterr().out
    env = tff.FriendFoe(environment_data={})
    np.testing.assert_array_equal(env._policies, np.full((3, 2), 0.5))
