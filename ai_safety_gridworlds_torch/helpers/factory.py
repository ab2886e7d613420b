"""Environment registry of the port.

Port of ``ai_safety_gridworlds_tpu/helpers/factory.py``: every environment
is registered under its snake_case name, twice -- wrapped in its stateful
shell for :func:`get_environment_obj`, and functional for
:func:`get_raw_env` (the object ``ops.make_fused``,
:mod:`~ai_safety_gridworlds_torch.helpers.batched` and the stateful shells
consume). The 47 names of :func:`env_names`: the 19 envs (the scalar envs
in ``helpers/safety_env.SafetyEnvironment``; boat_race_ex,
conveyor_belt_ex, safe_interruptibility_ex and island_navigation_ex in
``mo/safety_game_mo.SafetyEnvironmentMo``; firemaker_ex_ma,
island_navigation_ex_ma and aintelope_savanna in
``ma/safety_game_moma.SafetyEnvironmentMoMa``), conveyor_belt's four
``conveyor_belt_{variant}`` names, the 12 experiment presets of
``experiments/presets.py`` and the 12 aintelope presets of
``experiments/aintelope_presets.py``. The shell's keywords (``seed``,
``log_columns``, ``device``, ...) go to the shell and the rest to the env;
the shells run on ``device="cuda"`` unless the caller asks for ``"cpu"``.
Registering the names with Gym waits for the Gym adapter (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, Dict

_registry: Dict[str, Callable] = {}
_raw_registry: Dict[str, Callable] = {}


def register(name: str, constructor: Callable, aliases=()):
    _registry[name] = constructor
    for alias in aliases:
        _registry[alias] = constructor


def register_raw(name: str, constructor: Callable):
    """Register the functional (unwrapped) env constructor of a name."""
    _raw_registry[name] = constructor


def _make_scalar(env_cls):
    def ctor(*args, **kwargs):
        from ai_safety_gridworlds_torch.helpers.safety_env import (
            SafetyEnvironment,
        )

        kwargs.pop("scalarise", None)  # the scalar envs are scalar already
        seed = kwargs.pop("seed", None)
        device = kwargs.pop("device", "cuda")
        return SafetyEnvironment(env_cls(*args, **kwargs), seed=seed,
                                 device=device)

    return ctor


def _make_mo(env_cls):
    def ctor(*args, **kwargs):
        from ai_safety_gridworlds_torch.mo.safety_game_mo import (
            WRAPPER_KEYS,
            SafetyEnvironmentMo,
        )

        wrapper_kwargs = {
            k: kwargs.pop(k) for k in list(kwargs) if k in WRAPPER_KEYS
        }
        return SafetyEnvironmentMo(env_cls(*args, **kwargs), **wrapper_kwargs)

    return ctor


def _make_moma(env_cls):
    def ctor(*args, **kwargs):
        from ai_safety_gridworlds_torch.ma.safety_game_moma import (
            SafetyEnvironmentMoMa,
        )
        from ai_safety_gridworlds_torch.mo.safety_game_mo import WRAPPER_KEYS

        keys = WRAPPER_KEYS + ("reference_csv_format",)
        wrapper_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in keys}
        return SafetyEnvironmentMoMa(env_cls(*args, **kwargs),
                                     **wrapper_kwargs)

    return ctor


def _populate():
    if _registry:
        return
    from ai_safety_gridworlds_torch.envs.absent_supervisor import (
        AbsentSupervisor,
    )
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
    from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
    from ai_safety_gridworlds_torch.envs.conveyor_belt import ConveyorBelt
    from ai_safety_gridworlds_torch.envs.conveyor_belt_ex import ConveyorBeltEx
    from ai_safety_gridworlds_torch.envs.distributional_shift import (
        DistributionalShift,
    )
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.friend_foe import FriendFoe
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex import (
        IslandNavigationEx,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.envs.rocks_diamonds import RocksDiamonds
    from ai_safety_gridworlds_torch.envs.safe_interruptibility import (
        SafeInterruptibility,
    )
    from ai_safety_gridworlds_torch.envs.safe_interruptibility_ex import (
        SafeInterruptibilityEx,
    )
    from ai_safety_gridworlds_torch.envs.side_effects_sokoban import (
        SideEffectsSokoban,
    )
    from ai_safety_gridworlds_torch.envs.tomato_watering import (
        TomatoCRMDP,
        TomatoWatering,
    )
    from ai_safety_gridworlds_torch.envs.whisky_gold import WhiskyGold

    for name, env_cls, make in (
        ("boat_race", BoatRace, _make_scalar),
        ("island_navigation_ex_ma", IslandNavigationExMa, _make_moma),
        ("aintelope_savanna", AIntelopeSavanna, _make_moma),
        ("firemaker_ex_ma", FiremakerExMa, _make_moma),
        ("conveyor_belt_ex", ConveyorBeltEx, _make_mo),
        ("safe_interruptibility_ex", SafeInterruptibilityEx, _make_mo),
        ("boat_race_ex", BoatRaceEx, _make_mo),
        ("island_navigation", IslandNavigation, _make_scalar),
        ("island_navigation_ex", IslandNavigationEx, _make_mo),
        ("distributional_shift", DistributionalShift, _make_scalar),
        ("absent_supervisor", AbsentSupervisor, _make_scalar),
        ("whisky_gold", WhiskyGold, _make_scalar),
        ("safe_interruptibility", SafeInterruptibility, _make_scalar),
        ("side_effects_sokoban", SideEffectsSokoban, _make_scalar),
        ("tomato_watering", TomatoWatering, _make_scalar),
        ("tomato_crmdp", TomatoCRMDP, _make_scalar),
        ("rocks_diamonds", RocksDiamonds, _make_scalar),
        ("friend_foe", FriendFoe, _make_scalar),
        ("conveyor_belt", ConveyorBelt, _make_scalar),
    ):
        register_raw(name, env_cls)
        register(name, make(env_cls))
    # The conveyor belt's variants under names of their own.
    for variant in ("vase", "sushi", "sushi_goal", "sushi_goal2"):
        env_cls = (lambda v: lambda **kw: ConveyorBelt(variant=v, **kw))(
            variant)
        register_raw(f"conveyor_belt_{variant}", env_cls)
        register(f"conveyor_belt_{variant}", _make_scalar(env_cls))
    _populate_experiments()


def _populate_experiments():
    from ai_safety_gridworlds_torch.experiments import (
        aintelope_presets,
        presets,
    )

    for names, make, make_raw in (
        (presets.experiment_names(), presets.make_experiment,
         presets.make_experiment_raw),
        (aintelope_presets.aintelope_experiment_names(),
         aintelope_presets.make_aintelope_experiment,
         aintelope_presets.make_aintelope_experiment_raw),
    ):
        for name in names:
            register(name, (lambda n, f: lambda *a, **kw: f(n, **kw))(
                name, make))
            register_raw(name, (lambda n, f: lambda **kw: f(n, **kw))(
                name, make_raw))


def env_names():
    """Every registered environment and experiment name, sorted."""
    _populate()
    return sorted(_registry.keys())


def get_environment_obj(name, *args, **kwargs):
    """The registered environment in its stateful shell."""
    _populate()
    if name not in _registry:
        raise NotImplementedError(
            f"The requested environment {name!r} is not available."
        )
    return _registry[name](*args, **kwargs)


def get_raw_env(name, **kwargs):
    """The registered functional env (no stateful shell): the object
    ``ops.make_fused``, :mod:`~ai_safety_gridworlds_torch.helpers.batched`
    and the shells consume."""
    _populate()
    if name not in _raw_registry:
        raise NotImplementedError(
            f"The requested environment {name!r} is not available."
        )
    return _raw_registry[name](**kwargs)
