"""PyTorch / CUDA port of the AI Safety Gridworlds suite.

The JAX package ``ai_safety_gridworlds_tpu`` is the reference; this package
mirrors its sub-package and module layout (the counterpart of
``ai_safety_gridworlds_tpu/ops/fused_firemaker.py`` is
``ai_safety_gridworlds_torch/ops/fused_firemaker.py``) and keeps its packed
``[rows, B]`` state interface, so a port state compares with a JAX state
array by array. It imports ``torch`` and ``numpy``, never ``jax``.

Quick start (the stateful shells run on the card unless the caller asks
for the CPU)::

    from ai_safety_gridworlds_torch import get_environment_obj
    env = get_environment_obj("island_navigation_ex", device="cuda")
    timestep = env.reset()
    timestep = env.step(3)

:func:`get_environment_obj` builds any of the :func:`environment_names`
(the 19 envs, the four ``conveyor_belt_{variant}`` names, the 12
experiment presets and the 12 aintelope presets) in its stateful shell:
``helpers.safety_env.SafetyEnvironment`` for the scalar envs,
``mo.safety_game_mo.SafetyEnvironmentMo`` for the multi-objective ones and
the presets, ``ma.safety_game_moma.SafetyEnvironmentMoMa`` for
``firemaker_ex_ma``, ``island_navigation_ex_ma``, ``aintelope_savanna``
and the aintelope presets. :func:`register_with_gym` registers them with
Gym; the Gym and PettingZoo adapters
(``helpers.gridworld_gym_env.GridworldGymEnv``,
``helpers.gridworld_zoo_parallel_env.GridworldZooParallelEnv``,
``helpers.gridworld_zoo_aec_env.GridworldZooAecEnv``), the terminal viewer
(``helpers.agent_viewer``), the curses UI (``ui.safety_ui``), the
demonstrations and ``python -m ai_safety_gridworlds_torch.play -e <env>``
run over the same shells and take the same ``device`` keyword.

The batched paths: the fused rollouts of ``firemaker_ex_ma`` (K1), of the
15 scalar bodies (``boat_race``, ``island_navigation``, ``boat_race_ex``,
``island_navigation_ex``, ``absent_supervisor``, ``distributional_shift``,
``safe_interruptibility``, ``safe_interruptibility_ex``,
``side_effects_sokoban``, ``whisky_gold``, ``tomato_watering`` and
``tomato_crmdp``, ``conveyor_belt``, ``rocks_diamonds``, ``friend_foe``,
``conveyor_belt_ex``; K4), of ``island_navigation_ex_ma`` (K6) and of
``aintelope_savanna`` (K8) behind
:class:`~ai_safety_gridworlds_torch.helpers.batched.BatchedEnv` (uniform or
per-lane linear-policy actions), and fused-PPO training on each
(:mod:`ai_safety_gridworlds_torch.learners.ppo_fused`; the collections K3,
K5, K7 and K9), with hand-written CUDA kernels for the card and plain
PyTorch versions for CPU tensors. The generic batched path
(``BatchedEnv(..., backend="generic")``: JAX's threefry key chain in
:mod:`~ai_safety_gridworlds_torch.core.threefry`, ``core.base.rollout`` and
``ma.safety_game_ma.ma_rollout``, plain PyTorch on the card) runs the 15
scalar envs above (``whisky_gold`` with ``human_player=True`` only there),
``firemaker_ex_ma``, ``island_navigation_ex_ma`` and ``aintelope_savanna``,
and equals the JAX package's generic path from the same key. On it run the
generic learners, PPO (:mod:`~ai_safety_gridworlds_torch.learners.ppo`) and
A2C (:mod:`~ai_safety_gridworlds_torch.learners.actor_critic`), and the
stateful shells. Scale-out runs one process a device on
``torch.distributed`` (:mod:`~ai_safety_gridworlds_torch.parallel.mesh`,
:mod:`~ai_safety_gridworlds_torch.parallel.multihost`; the data-parallel
``ppo_fused.make_sharded_train_step``), and
:mod:`~ai_safety_gridworlds_torch.utils.checkpoint` and
:mod:`~ai_safety_gridworlds_torch.utils.profiling` save, resume and time
the runs. ``ROADMAP.md`` lists what is still to come.
"""

__version__ = "0.1.0"


def get_environment_obj(name, *args, **kwargs):
    """A registered environment or experiment in its stateful shell (the
    registry is imported on first use)."""
    from ai_safety_gridworlds_torch.helpers import factory

    return factory.get_environment_obj(name, *args, **kwargs)


def register_with_gym():
    """Register every name with Gym under ``{CamelCase}-v0`` and
    ``ai_safety_gridworlds.{name}-v0``."""
    from ai_safety_gridworlds_torch.helpers import factory

    return factory.register_with_gym()


def environment_names():
    """Every registered environment and experiment name."""
    from ai_safety_gridworlds_torch.helpers import factory

    return factory.env_names()
