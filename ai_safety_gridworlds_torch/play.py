"""Human-play CLI: ``python -m ai_safety_gridworlds_torch.play -e <env>``.

Port of ``ai_safety_gridworlds_tpu/play.py``, the human-play entry point of
every environment: build the environment by registry name, pick the key
map (scalar or MO/MA action ordering), colour it with the game module's
``GAME_BG_COLOURS`` / ``GAME_FG_COLOURS`` and run the curses UI.

Extra env flags pass through: ``-e island_navigation_ex --level 3``, and
``--device cpu`` runs the shell on the CPU (it runs on ``cuda`` else).
"""

from __future__ import annotations

import argparse
import importlib

from ai_safety_gridworlds_torch.helpers import factory


def _colours_for(env) -> tuple:
    module = importlib.import_module(type(env._game).__module__)
    return (
        getattr(module, "GAME_BG_COLOURS", {}),
        getattr(module, "GAME_FG_COLOURS", {}),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-e", "--environment", required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--turning_keys", action="store_true",
        help="bind keypad corner keys to TURN_* actions (mode-2 envs)",
    )
    parser.add_argument("--delay", type=int, default=None)
    parser.add_argument(
        "--eval", action="store_true",
        help="print a machine-readable results line to stderr at game "
        "over, for piping into eval harnesses",
    )
    args, extra = parser.parse_known_args(argv)

    env_kwargs = {}
    key = None
    for token in extra:
        if token.startswith("--"):
            key = token[2:]
            env_kwargs[key] = True
        elif key is not None:
            try:
                env_kwargs[key] = int(token)
            except ValueError:
                try:
                    env_kwargs[key] = float(token)
                except ValueError:
                    env_kwargs[key] = token
            key = None
    if args.seed is not None:
        env_kwargs.setdefault("seed", args.seed)

    env = factory.get_environment_obj(args.environment, **env_kwargs)
    colours_bg, colours_fg = _colours_for(env)

    from ai_safety_gridworlds_torch.mo.safety_game_mo import SafetyEnvironmentMo
    from ai_safety_gridworlds_torch.ui import safety_ui

    if isinstance(env, SafetyEnvironmentMo):
        ui = safety_ui.make_human_curses_ui_with_noop_keys(
            colours_bg,
            colours_fg,
            noop_keys=True,
            turning_keys=args.turning_keys,
            delay=args.delay if args.delay is not None else 50,
        )
    else:
        ui = safety_ui.make_human_curses_ui(
            colours_bg, colours_fg,
            delay=args.delay if args.delay is not None else 100,
        )
    ui.play(env, eval_mode=args.eval)


if __name__ == "__main__":
    main()
