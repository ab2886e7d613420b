"""The port's routing: ``BatchedEnv`` / ``batched_rollout`` / ``make_fused``
/ ``get_raw_env``, and the slice as a whole against the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa as TEnv
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv, batched_rollout
from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_batched_env_reports_plain_kernel_and_per_call_deltas():
    env = BatchedEnv("firemaker_ex_ma", batch_size=32, seed=4, device="cpu",
                     max_iterations=20)
    assert env.kernel == "fused_torch"
    assert isinstance(env.fused, TF)
    first = env.rollout(15)
    second = env.rollout(15)
    # t advances 2 per step: episodes end at step 10, restart at step 11,
    # end again at step 21.
    assert first["episodes"] == 32 and second["episodes"] == 32
    assert first["steps"] == second["steps"] == 15 * 32
    assert first["kernel"] == "fused_torch"
    total = env.state["stats_rewards"].to(torch.float64).sum(dim=-1).numpy()
    np.testing.assert_array_equal(
        first["sum_rewards"] + second["sum_rewards"], total
    )
    assert int(env.state["stats_episodes"].sum()) == 64


def test_batched_env_slice_matches_jax_eager():
    """The whole slice: registry -> make_fused -> init_packed -> rollout,
    against the JAX product-form step run eagerly from the same seed."""
    from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker

    env = BatchedEnv("firemaker_ex_ma", batch_size=16, seed=9, device="cpu",
                     max_iterations=16)
    stats = env.rollout(20)
    jf = FusedFiremaker(FiremakerExMa(max_iterations=16), mxu_stencil=False)
    jS = jf.init_packed(seed=9, batch=16)
    for _ in range(20):
        jS = jf.step_xla(jS)
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(
            env.state[k].numpy(), np.asarray(jS[k]), err_msg=k
        )
    assert stats["episodes"] == int(np.asarray(jS["stats_episodes"]).sum())


@pytest.mark.parametrize(
    "name", ["boat_race", "island_navigation", "boat_race_ex"]
)
def test_batched_env_scalar_slice_matches_jax(name):
    """The scalar slice as a whole: registry -> make_fused -> init_packed
    -> rollout, twice, against the JAX package's fused scalar rollout from
    the same seed."""
    from ai_safety_gridworlds_tpu import ops as jops
    from ai_safety_gridworlds_tpu.helpers import factory as jfactory

    env = BatchedEnv(name, batch_size=32, seed=6, device="cpu",
                     max_iterations=9)
    assert env.kernel == "fused_torch"
    first, second = env.rollout(12), env.rollout(12)
    jf = jops.make_fused(jfactory.get_raw_env(name, max_iterations=9))
    jS = jf.rollout(jf.init_packed(seed=6, batch=32), 24, backend="xla")
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(
            env.state[k].numpy(), np.asarray(jS[k]), err_msg=k
        )
    assert first["episodes"] + second["episodes"] == int(
        np.asarray(jS["stats_episodes"]).sum()
    )
    np.testing.assert_array_equal(
        first["sum_rewards"] + second["sum_rewards"],
        np.asarray(jS["stats_rewards"]).sum(axis=-1),
    )
    assert first["sum_rewards"].shape == (env.fused.D,)


@pytest.mark.parametrize("name,kw", [
    ("island_navigation_ex", {"max_iterations": 9,
                              "sustainability_challenge": False}),
    ("absent_supervisor", {}),
    ("distributional_shift", {"is_testing": True}),
    ("safe_interruptibility", {"level": 0}),
    ("safe_interruptibility_ex", {"max_iterations": 9}),
    ("side_effects_sokoban", {"level": 1}),
    ("whisky_gold", {}),
    ("tomato_crmdp", {}),
    ("conveyor_belt_sushi_goal", {"max_iterations": 9}),
    ("rocks_diamonds", {}),
    ("friend_foe", {}),
    ("conveyor_belt_ex", {"variant": "sushi_goal2", "max_iterations": 9}),
], ids=["island_navigation_ex", "absent_supervisor", "distributional_shift",
        "safe_interruptibility", "safe_interruptibility_ex",
        "side_effects_sokoban", "whisky_gold", "tomato_crmdp",
        "conveyor_belt_sushi_goal", "rocks_diamonds", "friend_foe",
        "conveyor_belt_ex"])
def test_batched_env_new_scalar_slice_matches_jax(name, kw):
    """island_navigation_ex, the bodies with per-episode draws and the
    bodies of the last scalar slice as a whole:
    registry -> make_fused -> init_packed (the host's first-episode draws)
    -> rollout, twice, against the JAX package's fused scalar rollout from
    the same seed, every field exact."""
    from ai_safety_gridworlds_tpu import ops as jops
    from ai_safety_gridworlds_tpu.helpers import factory as jfactory

    env = BatchedEnv(name, batch_size=32, seed=6, device="cpu", **kw)
    assert env.kernel == "fused_torch"
    first, second = env.rollout(12), env.rollout(12)
    jf = jops.make_fused(jfactory.get_raw_env(name, **kw))
    jS = jf.rollout(jf.init_packed(seed=6, batch=32), 24, backend="xla")
    for k in jf.STATE_FIELDS:
        got, want = env.state[k].numpy(), np.asarray(jS[k])
        if name == "tomato_crmdp" and k in ("hid_ret", "stats_hidden"):
            # XLA's jitted loop rewrites sum(watered) * 0.02
            # (tests/test_torch_fused_scalar_draws.py states the bound).
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert first["episodes"] + second["episodes"] == int(
        np.asarray(jS["stats_episodes"]).sum()
    )
    assert first["sum_rewards"].shape == (env.fused.D,)


def test_batched_env_island_ma_slice_matches_jax():
    """The island_navigation_ex_ma slice as a whole: registry -> make_fused
    -> init_packed -> rollout, twice, against the JAX package's jitted XLA
    rollout from the same seed."""
    from ai_safety_gridworlds_tpu import ops as jops
    from ai_safety_gridworlds_tpu.helpers import factory as jfactory

    env = BatchedEnv("island_navigation_ex_ma", batch_size=32, seed=6,
                     device="cpu", max_iterations=12)
    assert env.kernel == "fused_torch"
    first, second = env.rollout(10), env.rollout(10)
    jf = jops.make_fused(
        jfactory.get_raw_env("island_navigation_ex_ma", max_iterations=12)
    )
    jS = jf.rollout(jf.init_packed(seed=6, batch=32), 20, backend="xla")
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(
            env.state[k].numpy(), np.asarray(jS[k]), err_msg=k
        )
    assert first["episodes"] + second["episodes"] == int(
        np.asarray(jS["stats_episodes"]).sum()
    ) > 0
    np.testing.assert_array_equal(
        first["sum_rewards"] + second["sum_rewards"],
        np.asarray(jS["stats_rewards"]).sum(axis=-1),
    )
    assert first["sum_rewards"].shape == (env.fused.n * env.fused.D,)


def test_batched_env_savanna_slice_matches_jax():
    """The aintelope_savanna slice as a whole: registry -> make_fused ->
    init_packed -> rollout, twice, across per-episode redraws, against the
    JAX package's jitted XLA rollout from the same seed."""
    from ai_safety_gridworlds_tpu import ops as jops
    from ai_safety_gridworlds_tpu.helpers import factory as jfactory

    env = BatchedEnv("aintelope_savanna", batch_size=32, seed=6,
                     device="cpu", max_iterations=8)
    assert env.kernel == "fused_torch" and env.fused.exact_reset
    first, second = env.rollout(10), env.rollout(10)
    jf = jops.make_fused(
        jfactory.get_raw_env("aintelope_savanna", max_iterations=8)
    )
    jS = jf.rollout(jf.init_packed(seed=6, batch=32), 20, backend="xla")
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(
            env.state[k].numpy(), np.asarray(jS[k]), err_msg=k
        )
    assert first["episodes"] + second["episodes"] == int(
        np.asarray(jS["stats_episodes"]).sum()
    ) > 0
    np.testing.assert_array_equal(
        first["sum_rewards"] + second["sum_rewards"],
        np.asarray(jS["stats_rewards"]).sum(axis=-1),
    )


def test_batched_rollout_one_call():
    stats = batched_rollout("firemaker_ex_ma", batch_size=8, n_steps=4,
                            device="cpu", seed=1)
    assert stats["kernel"] == "fused_torch" and stats["steps"] == 32
    assert stats["sum_rewards"].shape == (TF(TEnv()).n * TF(TEnv()).D,)


def test_unported_names_and_backends_raise():
    # A name that no registry holds.
    with pytest.raises(NotImplementedError, match="not available"):
        BatchedEnv("no_such_env", batch_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="not available"):
        factory.get_raw_env("no_such_env")
    # An aintelope preset is a savanna under preset flags.
    assert factory.get_raw_env("food_sharing").name == "aintelope_savanna"
    # An env object that no fused kernel serves: make_fused gives None, as
    # the JAX package's does, and callers take the generic path.
    assert tops.make_fused(type("Env", (), {"name": "food_sharing"})()) is None
    # backend="generic" runs the generic path (two sub-steps a step, so
    # max_iterations=6 ends every lane's episode at step 3).
    env = BatchedEnv("firemaker_ex_ma", batch_size=8, device="cpu",
                     backend="generic", max_iterations=6)
    assert env.kernel == "generic_torch" and env.fused is None
    stats = env.rollout(4)
    assert stats["kernel"] == "generic_torch" and stats["episodes"] == 8
    assert stats["sum_rewards"].shape == (2, 4)
    with pytest.raises(AttributeError):
        env.state
    # Every registered name has its per-env chain now: the generic path
    # runs the island and savanna multi-agent chains too.
    for name in ("island_navigation_ex_ma", "aintelope_savanna"):
        env = BatchedEnv(name, batch_size=8, device="cpu",
                         backend="generic", max_iterations=6)
        stats = env.rollout(7)
        assert stats["kernel"] == "generic_torch" and stats["episodes"] >= 8
        assert stats["sum_rewards"].shape == (env.env.n_agents,
                                              env.env.reward_space.n_dims)
    with pytest.raises(ValueError):
        BatchedEnv("firemaker_ex_ma", batch_size=8, device="cpu",
                   backend="bogus")
    # Observation mode 2 with a fixed action mode, as the JAX BatchedEnv
    # takes it: the fused kernel refuses the configuration, "auto" falls
    # back to the generic path, whose rollout refuses it; "fused" raises.
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv as JB

    jenv = JB("firemaker_ex_ma", 8, observation_direction_mode=2)
    tenv = BatchedEnv("firemaker_ex_ma", batch_size=8, device="cpu",
                      observation_direction_mode=2)
    assert (jenv.kernel, tenv.kernel) == ("generic_vmap", "generic_torch")
    assert jenv.fused is None and tenv.fused is None
    for env in (jenv, tenv):
        with pytest.raises(NotImplementedError, match="observation mode 2"):
            env.rollout(1)
    with pytest.raises(NotImplementedError):
        JB("firemaker_ex_ma", 8, observation_direction_mode=2,
           backend="fused")
    with pytest.raises(NotImplementedError):
        BatchedEnv("firemaker_ex_ma", batch_size=8, device="cpu",
                   observation_direction_mode=2, backend="fused")


def test_savanna_topup_beyond_the_free_cells_runs_generic_as_jax():
    """The top-up that K8's packer refuses (``amount_food_patches=200``):
    "auto" falls back to the generic chain, whose per-call stats equal the
    JAX BatchedEnv's generic path; "fused" raises the packer's ValueError
    on both."""
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv as JB

    jenv = JB("aintelope_savanna", 8, amount_food_patches=200,
              max_iterations=10)
    tenv = BatchedEnv("aintelope_savanna", batch_size=8, device="cpu",
                      amount_food_patches=200, max_iterations=10)
    assert (jenv.kernel, tenv.kernel) == ("generic_vmap", "generic_torch")
    for _ in range(2):
        a, b = jenv.rollout(12), tenv.rollout(12)
        assert a["episodes"] == b["episodes"] == 8
        np.testing.assert_array_equal(a["sum_rewards"], b["sum_rewards"])
    for make in (JB, lambda *a, **k: BatchedEnv(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="top up"):
            make("aintelope_savanna", 8, backend="fused",
                 amount_food_patches=200)


def test_static_kernel_limits_are_one_predicate():
    """``check_static_limits`` holds what K6/K7 and K8/K9 lack whatever the
    state; ``_check_launch`` and (on a CUDA device) ``init_packed`` raise
    it. On the CPU the plain versions take such configurations."""
    from ai_safety_gridworlds_torch.ops import fused_island_ma as IM
    from ai_safety_gridworlds_torch.ops import fused_savanna as SV

    island = IM.FusedIslandMa(factory.get_raw_env("island_navigation_ex_ma"))
    island.init_packed(0, 4, "cpu")
    IM.check_static_limits(island)
    island.n = 5
    with pytest.raises(NotImplementedError, match="agents"):
        IM.check_static_limits(island)
    island.n, island.layout_pool = 2, 9
    with pytest.raises(NotImplementedError, match="layout pool"):
        IM.check_static_limits(island)
    island.layout_pool, island.HW = 1, 4097
    with pytest.raises(NotImplementedError, match="cells"):
        IM.check_static_limits(island)
    # Five savanna agents: K8 takes four; the CPU runs the plain version.
    five = SV.FusedSavanna(factory.get_raw_env("aintelope_savanna",
                                               amount_agents=5))
    with pytest.raises(NotImplementedError, match="agents"):
        SV.check_static_limits(five)
    env = BatchedEnv("aintelope_savanna", batch_size=4, device="cpu",
                     amount_agents=5)
    assert env.kernel == "fused_torch"
    # A board no block holds even at 32 threads a lane.
    big = SV.FusedSavanna(factory.get_raw_env(
        "aintelope_savanna", map_width=250, map_height=250))
    with pytest.raises(NotImplementedError, match="fit no block"):
        SV.check_static_limits(big)


@pytest.mark.parametrize("error,falls_back", [
    (ValueError("layout refused"), True),
    (NotImplementedError("configuration refused"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
], ids=["ValueError", "NotImplementedError", "RuntimeError", "OutOfMemory"])
def test_auto_falls_back_only_on_a_packer_refusal(monkeypatch, caplog, error,
                                                   falls_back):
    # "auto" takes the generic path, with a warning, only when the packer
    # refuses the configuration; any other error of init_packed reaches
    # the caller. "fused" never falls back.
    def refuse(self, seed, batch, device, tile=None):
        raise error

    monkeypatch.setattr(TF, "init_packed", refuse)
    if falls_back:
        with caplog.at_level("WARNING"):
            env = BatchedEnv("firemaker_ex_ma", batch_size=4, device="cpu")
        assert env.kernel == "generic_torch" and env.fused is None
        assert "falling back to the generic path" in caplog.text
    else:
        with pytest.raises(type(error)):
            BatchedEnv("firemaker_ex_ma", batch_size=4, device="cpu")
    with pytest.raises(type(error)):
        BatchedEnv("firemaker_ex_ma", batch_size=4, device="cpu",
                   backend="fused")


# Configurations the JAX package's fused tests route through make_fused,
# and the refused ones: None (the generic path) on both sides or neither.
MAKE_FUSED_CASES = [
    ("firemaker_ex_ma", {}),
    ("firemaker_ex_ma", {"amount_agents": 3}),
    ("firemaker_ex_ma", {"action_direction_mode": 2,
                         "observation_direction_mode": 2}),
    ("firemaker_ex_ma", {"observation_direction_mode": 2}),
    ("island_navigation_ex_ma", {}),
    ("island_navigation_ex_ma", {"observation_direction_mode": 2,
                                 "action_direction_mode": 0}),
    ("aintelope_savanna", {}),
    ("aintelope_savanna", {"sustainability_challenge": True}),
    ("aintelope_savanna", {"amount_food_patches": 200}),
    ("whisky_gold", {}),
    ("whisky_gold", {"human_player": True}),
    ("boat_race", {}),
    ("island_navigation", {}),
    ("side_effects_sokoban", {"level": 1}),
    ("tomato_crmdp", {}),
    ("conveyor_belt_sushi", {}),
]


@pytest.mark.parametrize("name,kw", MAKE_FUSED_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(MAKE_FUSED_CASES)])
def test_make_fused_refusals_match_jax(name, kw):
    from ai_safety_gridworlds_tpu import ops as jops
    from ai_safety_gridworlds_tpu.helpers import factory as jfactory

    jf = jops.make_fused(jfactory.get_raw_env(name, **kw))
    tf = tops.make_fused(factory.get_raw_env(name, **kw))
    assert (jf is None) == (tf is None)
    if tf is not None:
        assert type(tf).__name__ == type(jf).__name__


def test_whisky_human_player_runs_only_on_the_generic_path(caplog):
    """No fused kernel takes the human player's hijack: "auto" falls back
    to the generic path with a warning, as the JAX BatchedEnv does, and
    "fused" raises."""
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv as JB

    jenv = JB("whisky_gold", 8, human_player=True)
    with caplog.at_level("WARNING"):
        tenv = BatchedEnv("whisky_gold", 8, device="cpu", human_player=True)
    assert "falling back to the generic path" in caplog.text
    assert (jenv.kernel, tenv.kernel) == ("generic_vmap", "generic_torch")
    stats = tenv.rollout(120)
    assert stats["kernel"] == "generic_torch" and stats["episodes"] >= 8
    # The same stats as the generic path's rollout from BatchedEnv's key.
    from ai_safety_gridworlds_torch.core import base, threefry

    sub = threefry.split(threefry.PRNGKey(0))[1]
    _, raw = base.rollout(factory.get_raw_env("whisky_gold",
                                              human_player=True),
                          sub, 120, 8, device="cpu")
    assert stats["episodes"] == int(raw["episodes"])
    with pytest.raises(NotImplementedError):
        BatchedEnv("whisky_gold", 8, device="cpu", human_player=True,
                   backend="fused")
    # Agent mode keeps the fused kernel.
    assert BatchedEnv("whisky_gold", 8, device="cpu").kernel == "fused_torch"
    if not torch.cuda.is_available():  # nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedEnv("whisky_gold", 8, human_player=True)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEnv("firemaker_ex_ma", batch_size=8)  # device="cuda" default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_rollout("firemaker_ex_ma", batch_size=8, n_steps=1,
                        device="cuda")


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import ai_safety_gridworlds_torch.helpers.batched\n"
        "import ai_safety_gridworlds_torch.ops.fused_firemaker\n"
        "import ai_safety_gridworlds_torch.ops.interop\n"
        "import ai_safety_gridworlds_torch.ops._cuda\n"
        "import ai_safety_gridworlds_torch.learners.ppo_fused\n"
        "from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv\n"
        "import ai_safety_gridworlds_torch.ops.fused_scalar\n"
        "import ai_safety_gridworlds_torch.ops.fused_island_ma\n"
        "import ai_safety_gridworlds_torch.ops.fused_savanna\n"
        "import ai_safety_gridworlds_torch.mo.map_randomization\n"
        "BatchedEnv('firemaker_ex_ma', batch_size=4, device='cpu').rollout(2)\n"
        "BatchedEnv('boat_race', 4, device='cpu').rollout(2)\n"
        "BatchedEnv('island_navigation_ex', 4, device='cpu').rollout(2)\n"
        "BatchedEnv('absent_supervisor', 4, device='cpu').rollout(2)\n"
        "for n in ('side_effects_sokoban', 'tomato_watering', 'friend_foe',\n"
        "          'conveyor_belt_vase', 'conveyor_belt_ex', 'rocks_diamonds',\n"
        "          'whisky_gold'):\n"
        "    BatchedEnv(n, 4, device='cpu').rollout(2)\n"
        "BatchedEnv('island_navigation_ex_ma', 4, device='cpu',\n"
        "           map_randomization_frequency=1).rollout(2)\n"
        "BatchedEnv('aintelope_savanna', 4, device='cpu',\n"
        "           sustainability_challenge=True).rollout(2)\n"
        "for n in ('firemaker_ex_ma', 'boat_race', 'island_navigation'):\n"
        "    BatchedEnv(n, 4, device='cpu', backend='generic').rollout(2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ai_safety_gridworlds_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
