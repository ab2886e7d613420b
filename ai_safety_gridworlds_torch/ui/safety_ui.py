"""Human-playable curses UI for the gridworld environments.

Port of ``ai_safety_gridworlds_tpu/ui/safety_ui.py``: the interactive
terminal UI (``SafetyCursesUi``, ``SafetyCursesUiEx``,
``make_human_curses_ui`` and ``make_human_curses_ui_with_noop_keys``) over
the port's stateful shells (:class:`SafetyEnvironment`,
:class:`SafetyEnvironmentMo`, :class:`SafetyEnvironmentMoMa`), on whatever
device the shell runs.

The frames are built by pure functions (``render_frame``,
``eval_results_line``), so they are testable without a terminal; the
curses loop is a thin shell around them.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

from ai_safety_gridworlds_torch.core.actions import Actions, ActionsMo


def _env_char_rows(env) -> list:
    """Current board as a list of strings of raw tile characters."""
    board = np.asarray(env.char_board())
    return ["".join(chr(c) for c in row) for row in board]


def _fmt_reward(reward) -> str:
    if reward is None:
        return "None"
    if isinstance(reward, dict):
        return " ".join(f"{k}:{_fmt_reward(v)}" for k, v in reward.items())
    arr = np.asarray(reward)
    if arr.ndim == 0:
        return f"{float(arr):g}"
    return "[" + ", ".join(f"{float(v):g}" for v in arr) + "]"


def _hstack_panels(panels: list, gap: int = 3) -> list:
    """Lay out lists of rows side by side (per-agent panels in adjacent
    screen columns)."""
    panels = [p for p in panels if p]
    if not panels:
        return []
    height = max(len(p) for p in panels)
    widths = [max((len(r) for r in p), default=0) for p in panels]
    rows = []
    for y in range(height):
        parts = [
            (p[y] if y < len(p) else "").ljust(w)
            for p, w in zip(panels, widths)
        ]
        rows.append((" " * gap).join(parts).rstrip())
    return rows


def _split_agent_metrics(metrics: dict, agent_names: list) -> tuple:
    """Partition metrics into (global, {agent: {stripped_key: value}}) by
    the ``<name>_<agent char>`` suffix convention."""
    global_metrics, per_agent = {}, {a: {} for a in agent_names}
    for key, value in metrics.items():
        parts = key.split("_")
        if len(parts) > 1 and parts[-1] in per_agent:
            per_agent[parts[-1]]["_".join(parts[:-1])] = value
        else:
            global_metrics[key] = value
    return global_metrics, per_agent


def _agent_board_panels(env) -> Optional[list]:
    """Global map + per-agent perspective boards, side by side
    None for single-agent environments."""
    if not (
        hasattr(env, "agent_perspectives_with_layers")
        and getattr(env, "agent_names", None)
    ):
        return None
    try:
        obs = env.last_observation()
    except Exception:
        return None
    if "ascii_codes" not in obs:
        return None
    perspectives = env.agent_perspectives_with_layers(
        obs, include_layers=False, board=False, ascii=True
    )
    panels = [["Global map", ""] + _env_char_rows(env)]
    for agent, entry in perspectives.items():
        board = np.asarray(entry["ascii"])
        panels.append(
            [f"Agent {agent}", ""]
            + ["".join(str(c) for c in row) for row in board]
        )
    return panels


def _kv_panel(title: str, items: dict) -> list:
    width = max([len(str(k)) for k in items] + [0]) + 2
    return [title] + [
        f"  {str(k).ljust(width)}{float(v):g}" for k, v in items.items()
    ]


def render_frame(env, timestep=None, elapsed: Optional[float] = None) -> list:
    """The frame as rows of text: the board and the status lines (no
    curses needed)."""
    agent_panels = _agent_board_panels(env)
    if agent_panels:
        rows = _hstack_panels(agent_panels)
    else:
        rows = list(_env_char_rows(env))
    rows.append("")
    if timestep is not None:
        rows.append(f"Step type: {timestep.step_type!s}")
        rows.append(f"Reward:    {_fmt_reward(timestep.reward)}")
    ret = getattr(env, "episode_return", None)
    if ret is not None:
        rows.append(f"Return:    {_fmt_reward(ret)}")
    # Trial/episode counters on screen (``CHANGES.md`` v2.4.1).
    if hasattr(env, "get_env_layout_seed") and hasattr(env, "get_episode_no"):
        rows.append(
            f"Trial: {env.get_env_layout_seed()}  "
            f"Episode: {env.get_episode_no()}"
        )
    obs = (
        timestep.observation
        if timestep is not None and isinstance(timestep.observation, dict)
        else {}
    )
    metrics = obs.get("metrics_dict")
    agent_names = getattr(env, "agent_names", None)
    if metrics and agent_names:
        global_metrics, per_agent = _split_agent_metrics(
            dict(sorted(metrics.items())), agent_names
        )
        if global_metrics:
            rows.extend(_kv_panel("Global metrics:", global_metrics))
        panels = [
            [f"Agent {a}", ""] + _kv_panel("Metrics:", per_agent[a])
            for a in agent_names
            if per_agent[a]
        ]
        rows.extend(_hstack_panels(panels))
    elif metrics:
        for k in sorted(metrics):
            rows.append(f"  {k}: {float(metrics[k]):g}")
    # Per-agent reward-dimension panels, or the MO dimension breakdown.
    cumulative = obs.get("cumulative_reward_dict")
    last = obs.get("reward_dict")
    if isinstance(cumulative, dict) and cumulative and agent_names:
        panels = []
        for a in agent_names:
            panel = [f"Agent {a}", ""]
            if isinstance(last, dict) and isinstance(last.get(a), dict):
                panel += _kv_panel("Last score:", last[a]) + [""]
            if isinstance(cumulative.get(a), dict):
                panel += _kv_panel("Episode return:", cumulative[a])
            panels.append(panel)
        rows.extend([""] + _hstack_panels(panels))
    elif isinstance(cumulative, dict) and cumulative:
        if isinstance(last, dict) and last:
            rows.extend([""] + _kv_panel("Last reward:", last))
        rows.extend([""] + _kv_panel("Episode return:", cumulative))
    if elapsed is not None:
        rows.append(
            "Elapsed: " + str(datetime.timedelta(seconds=int(elapsed)))
        )
    # Game console: drain the env's log messages.
    if hasattr(env, "consume_log_messages"):
        for message in env.consume_log_messages():
            rows.append("> " + message)
    return rows


def eval_results_line(env, score=None, now=None) -> str:
    """Machine-readable end-of-game results line for eval harnesses.

    The ``--eval`` output on stderr: a ``{score: ..., safety_performance: ...,
    termination_reason: ..., date: ..., environment_data: ...}`` line meant
    for piping to a file.
    """
    if score is None:
        score = getattr(env, "episode_return", None)
    safety_performance = (
        env.get_overall_performance()
        if hasattr(env, "get_overall_performance")
        else None
    )
    termination_reason = getattr(env, "environment_data", {}).get(
        "termination_reason"
    )
    if now is None:
        # Naive UTC, in utcnow()'s output format.
        now = datetime.datetime.now(datetime.timezone.utc).replace(
            tzinfo=None
        )
    datastr = (
        "score: {}, "
        "safety_performance: {}, "
        "termination_reason: {!s}, "
        "date: {}, "
        "environment_data: {}"
    ).format(
        score,
        safety_performance,
        termination_reason,
        now,
        getattr(env, "environment_data", {}),
    )
    return "{" + datastr + "}"


def print_game_summary(env, ui, duration=None, eval_mode=False, file=None):
    """Post-game statistics printer: final score
    and termination reason to stdout; in eval mode additionally the
    machine-readable results line to stderr (or ``file``)."""
    import sys

    score = getattr(ui, "last_episode_return", None)
    if score is None:
        score = getattr(env, "episode_return", None)
    dur = str(duration).split(".")[0] if duration is not None else "?"
    print(f"Game over! Final score is {score}, earned over {dur}.")
    reason = getattr(env, "environment_data", {}).get("termination_reason")
    print(f"Termination reason: {reason!s}")
    if eval_mode:
        print(
            eval_results_line(env, score=score),
            file=file if file is not None else sys.stderr,
        )
    else:
        perf = (
            env.get_overall_performance()
            if hasattr(env, "get_overall_performance")
            else None
        )
        if perf is not None:
            print(f"Safety performance is {perf}.")


def curses_colours(colour_map: dict) -> dict:
    """Map chars to curses 0-1000 RGB triples (the games' colours are
    0-999, so values pass through; larger ones are clipped to 1000)."""
    return {
        c: tuple(min(1000, int(v)) for v in rgb)
        for c, rgb in (colour_map or {}).items()
    }


class SafetyCursesUi:
    """Interactive curses loop over a stateful environment shell.

    Arrow keys move, ``q`` quits, space and the keypad's centre are NOOP
    when enabled. In a multi-agent (MoMa) environment each keypress acts
    for the current agent and moves on to the next one."""

    def __init__(
        self,
        keys_to_actions: dict,
        delay: Optional[int] = None,
        repainter=None,
        colour_fg: Optional[dict] = None,
        colour_bg: Optional[dict] = None,
    ):
        self._keys_to_actions = dict(keys_to_actions)
        self._delay = delay
        self._repainter = repainter
        self._colour_fg = curses_colours(colour_fg or {})
        self._colour_bg = curses_colours(colour_bg or {})
        self._env = None
        self._timestep = None

    # ----------------------------------------------------------- headless API

    def attach(self, env):
        self._env = env
        self._timestep = env.reset()
        self.last_game_over = False
        return self._timestep

    def apply_key(self, key):
        """Map one key to an action and step the environment. Returns the new
        timestep, or None if the key is unbound. Pure of curses — used by the
        interactive loop and by tests."""
        if self._env is None:
            raise RuntimeError("attach(env) first")
        action = self._keys_to_actions.get(key)
        if action is None:
            return None
        action = int(action)
        agent_names = getattr(self._env, "agent_names", None)
        if agent_names:  # multi-agent: act current agent, cycle
            idx = getattr(self, "_current_agent", 0) % len(agent_names)
            self._timestep = self._env.step({agent_names[idx]: action})
            self._current_agent = (idx + 1) % len(agent_names)
        else:
            self._timestep = self._env.step(action)
        if self._episode_over():
            # Keep the finished episode's return readable (the env's own
            # accumulator resets with the episode).
            self.last_episode_return = getattr(
                self._env, "episode_return", None
            )
            self.last_game_over = True
            self._timestep = self._env.reset()
            self._current_agent = 0
        return self._timestep

    def _episode_over(self) -> bool:
        ts = self._timestep
        st = ts.step_type
        if isinstance(st, dict):
            return all(int(v) in (2, 3) for v in st.values())
        return int(st) == 2

    # --------------------------------------------------------- interactive

    def play(self, env, eval_mode=False):
        """Initialise curses, run the interaction loop, then print the
        post-game statistics (machine-readable to stderr in eval mode)."""
        import curses

        start = datetime.datetime.now()
        self.attach(env)
        curses.wrapper(self._loop)
        print_game_summary(
            env, self, duration=datetime.datetime.now() - start,
            eval_mode=eval_mode,
        )

    def _loop(self, screen):
        import curses

        curses.curs_set(0)
        pairs = {}
        if curses.has_colors() and self._colour_bg:
            curses.start_color()
            next_colour, next_pair = 16, 1
            for i, (c, bg) in enumerate(sorted(self._colour_bg.items())):
                if next_colour + 1 >= curses.COLORS or next_pair >= curses.COLOR_PAIRS:
                    break
                fg = self._colour_fg.get(c, (0, 0, 0))
                try:
                    curses.init_color(next_colour, *bg)
                    curses.init_color(next_colour + 1, *fg)
                    curses.init_pair(next_pair, next_colour + 1, next_colour)
                    pairs[c] = curses.color_pair(next_pair)
                except curses.error:
                    break
                next_colour += 2
                next_pair += 1
        if self._delay is not None:
            screen.timeout(self._delay)
        import time

        start = time.monotonic()
        full_redraw = True
        while True:
            if full_redraw:
                screen.erase()
                for y, row in enumerate(
                    render_frame(self._env, self._timestep)
                ):
                    for x, ch in enumerate(row):
                        attr = pairs.get(ch, 0)
                        try:
                            screen.addstr(y + 1, x, ch, attr)
                        except Exception:
                            pass
            # The clock updates every refresh; everything else only redraws
            # when the state may have changed (less flicker).
            elapsed = datetime.timedelta(seconds=int(time.monotonic() - start))
            try:
                screen.addstr(0, 2, str(elapsed), 0)
            except Exception:
                pass
            screen.refresh()
            key = screen.getch()
            if key == 27:  # ESC exits the UI
                return
            if key == -1:
                # Timeout tick: acts as NOOP when bound, otherwise only the
                # clock needs updating.
                if " " not in self._keys_to_actions:
                    full_redraw = False
                    continue
                key = " "
            name = (
                chr(key) if isinstance(key, int) and 0 <= key < 256 else key
            )
            full_redraw = False
            for candidate in (key, name):
                if candidate in self._keys_to_actions:
                    self.apply_key(candidate)
                    full_redraw = True
                    break
            # One episode per play() call (the loop ends at game over):
            # interactively recorded demonstrations must not span
            # episodes.
            if self.last_game_over:
                return


class SafetyCursesUiEx(SafetyCursesUi):
    """Extended UI: the reward dimension vectors and the metrics dict in
    the status area, which ``render_frame`` already draws when present."""


def make_human_curses_ui(game_bg_colours, game_fg_colours, delay=100):
    """Scalar-environment key map."""
    import curses

    return SafetyCursesUi(
        keys_to_actions={
            curses.KEY_UP: Actions.UP,
            curses.KEY_DOWN: Actions.DOWN,
            curses.KEY_LEFT: Actions.LEFT,
            curses.KEY_RIGHT: Actions.RIGHT,
            "q": Actions.QUIT,
            "Q": Actions.QUIT,
        },
        delay=delay,
        colour_fg=game_fg_colours,
        colour_bg=game_bg_colours,
    )


def make_human_curses_ui_with_noop_keys(
    game_bg_colours, game_fg_colours, noop_keys, turning_keys=False, delay=50
):
    """MO/MA-environment key map."""
    import curses

    keys_to_actions = {
        curses.KEY_UP: ActionsMo.UP,
        curses.KEY_DOWN: ActionsMo.DOWN,
        curses.KEY_LEFT: ActionsMo.LEFT,
        curses.KEY_RIGHT: ActionsMo.RIGHT,
        "q": ActionsMo.QUIT,
        "Q": ActionsMo.QUIT,
    }
    if noop_keys:
        keys_to_actions.update(
            {
                curses.KEY_B2: ActionsMo.NOOP,
                " ": ActionsMo.NOOP,
            }
        )
    if turning_keys:
        keys_to_actions.update(
            {
                curses.KEY_A1: ActionsMo.TURN_LEFT_90,
                curses.KEY_HOME: ActionsMo.TURN_LEFT_90,
                curses.KEY_A3: ActionsMo.TURN_RIGHT_90,
                curses.KEY_PPAGE: ActionsMo.TURN_RIGHT_90,
                curses.KEY_C1: ActionsMo.TURN_LEFT_180,
                curses.KEY_END: ActionsMo.TURN_LEFT_180,
                curses.KEY_C3: ActionsMo.TURN_RIGHT_180,
                curses.KEY_NPAGE: ActionsMo.TURN_RIGHT_180,
            }
        )
    return SafetyCursesUiEx(
        keys_to_actions=keys_to_actions,
        delay=delay,
        repainter=None,
        colour_fg=game_fg_colours,
        colour_bg=game_bg_colours,
    )
