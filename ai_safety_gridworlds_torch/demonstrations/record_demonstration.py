"""Records a new demonstration from an episode played in the curses UI.

Port of ``ai_safety_gridworlds_tpu/demonstrations/record_demonstration.py``:
play one episode with the keyboard, and print a ``Demonstration`` tuple
(seed, action string, episode return, safety performance, terminates)
suitable for pasting into :mod:`demonstrations`.

    $ python -m ai_safety_gridworlds_torch.demonstrations.record_demonstration \\
          --environment=safe_interruptibility [--seed=17] [--device=cpu]

The shell runs on ``--device`` (``cuda`` unless asked for ``cpu``).

If the episode does not terminate on its own, press ``q`` (quit); the quit
action is stripped from the recorded sequence and ``terminates`` is False.
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np

from ai_safety_gridworlds_torch.demonstrations import demonstrations
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ui import safety_ui


def _postprocess_actions(actions_list):
    to_char = {a: c for c, a in demonstrations._actions.items()}
    return "".join(to_char[int(a)] for a in actions_list if a is not None)


def record(environment: str, seed=None, ui_factory=None, scripted_keys=None,
           device="cuda"):
    """Record one episode; returns the ``Demonstration``.

    ``scripted_keys`` bypasses curses for tests: a list of keys fed through
    the UI's key→action→step mapping instead of an interactive loop.
    """
    if seed is None:
        seed = int(np.random.randint(0, 100))
    np.random.seed(seed)

    actions_list = []
    env = factory.get_environment_obj(environment, device=device)
    module = importlib.import_module(type(env._game).__module__)

    old_step = env.step

    def _step(action, *args, **kwargs):
        actions_list.append(action)
        return old_step(action, *args, **kwargs)

    env.step = _step

    colours_bg = getattr(module, "GAME_BG_COLOURS", {})
    colours_fg = getattr(module, "GAME_FG_COLOURS", {})
    if ui_factory is None:
        ui_factory = safety_ui.make_human_curses_ui
    ui = ui_factory(colours_bg, colours_fg)
    if scripted_keys is not None:
        ui.attach(env)
        for key in scripted_keys:
            ui.apply_key(key)
    else:
        ui.play(env)

    episode_return = getattr(ui, "last_episode_return", None)
    if episode_return is None:
        episode_return = env.episode_return
    safety_performance = env.get_overall_performance()
    actions = _postprocess_actions(actions_list)

    if actions and actions[-1] == "q":
        actions = actions[:-1]
        terminates = False
    else:
        terminates = True

    return demonstrations.Demonstration(
        seed, actions, episode_return, safety_performance, terminates
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--environment", required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    demo = record(args.environment, args.seed, device=args.device)
    print(f"Recorded the following data:\n{demo}")


if __name__ == "__main__":
    main()
