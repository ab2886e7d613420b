"""The port's curses UI helpers, terminal viewer, demonstration recorder and
play CLI against the JAX package's, on the CPU, without a terminal.

``render_frame`` on a scalar, an MO and a multi-agent shell through a few
steps, the game console, ``eval_results_line`` and ``print_game_summary``
with a fixed clock, ``curses_colours`` over every game's colours, the
key-driven UI (agents cycling in a multi-agent env, the game-over flag),
a headless ``AgentViewer`` on a frozen clock, ``record_demonstration`` with
scripted keys and ``play.main`` on a scripted UI: each run through the JAX
package first and then the port (``tests/test_torch_gym_adapter.py``'s
harness), every frame, line and tuple equal.
"""

import curses
import datetime
import importlib
import re
import types

import pytest

import ai_safety_gridworlds_torch.helpers.agent_viewer as tav
import ai_safety_gridworlds_tpu.helpers.agent_viewer as jav
from ai_safety_gridworlds_tpu import play as jplay
from ai_safety_gridworlds_tpu.demonstrations import (
    record_demonstration as jrec,
)
from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.ui import safety_ui as jui
from ai_safety_gridworlds_torch import play as tplay
from ai_safety_gridworlds_torch.demonstrations import (
    record_demonstration as trec,
)
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.ui import safety_ui as tui
from test_torch_gym_adapter import fresh_statics, pair  # noqa: F401
from test_torch_safety_env import assert_same
from torch_threads import one_torch_thread  # noqa: F401

KEY_OF = {"u": curses.KEY_UP, "d": curses.KEY_DOWN, "l": curses.KEY_LEFT,
          "r": curses.KEY_RIGHT, "q": "q", " ": " "}


def shell_make(name, **kw):
    def make(pkg):
        if pkg == "jax":
            return jfactory.get_environment_obj(name, **kw)
        return tfactory.get_environment_obj(name, device="cpu", **kw)
    return make


def ui_of(env):
    return tui if type(env).__module__.startswith(
        "ai_safety_gridworlds_torch") else jui


def plain(run):
    """A run of ``pair`` whose entries need no regrowth flag."""
    def wrapped(env, near):
        trace = run(env)
        if near is not None:
            near += [False] * len(trace)
        return trace
    return wrapped


def fixed_datetime_module():
    """A ``datetime`` module whose clock stands at one instant."""
    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2024, 5, 6, 7, 8, 9, tzinfo=tz)

    fake = types.ModuleType("datetime")
    fake.datetime = Frozen
    fake.timezone = datetime.timezone
    fake.timedelta = datetime.timedelta
    return fake


@pytest.mark.parametrize("name,kw,actions", [
    ("boat_race", {}, [4, 4, 2, 2]),
    ("boat_race_ex", {}, [2, 2, 4, 3]),
    ("island_navigation_ex", {"level": 3}, [4, 3, 1, 2]),
    ("firemaker_ex_ma", {}, [2, 1, 3, 4]),
    ("aintelope_savanna", {"amount_agents": 2, "level": 13}, [1, 2, 3, 0]),
])
def test_render_frame_equals_jax(name, kw, actions):
    def run(env):
        ts = env.reset()
        frames = [ui_of(env).render_frame(env, ts, elapsed=61.5)]
        for a in actions:
            if getattr(env, "agent_names", None):
                a = {c: a for c in env.agent_names}
            ts = env.step(a)
            frames.append(ui_of(env).render_frame(env, ts))
        return frames

    _, frames, _ = pair(shell_make(name, **kw), plain(run))
    assert "Elapsed: 0:01:01" in frames[0]
    if name == "firemaker_ex_ma":
        assert "Global map" in frames[1][0] and "Agent S" in frames[1][0]
        assert "Global metrics:" in "\n".join(frames[1])


def test_console_drains_equal_jax():
    def run(env):
        env.reset()
        env.log("hello from the game")
        ui = ui_of(env)
        return [ui.render_frame(env), ui.render_frame(env)]

    _, frames, _ = pair(shell_make("boat_race"), plain(run))
    assert "> hello from the game" in frames[0]
    assert not any(r.startswith(">") for r in frames[1])


def run_to_game_over(env, key=curses.KEY_RIGHT, limit=120):
    """A UI of the env's package driven with one key to the episode's
    end."""
    ui = ui_of(env).SafetyCursesUi(keys_to_actions={key: 4})
    ui.attach(env)
    flags = [ui.last_game_over]
    for _ in range(limit):
        ui.apply_key(key)
        if ui.last_game_over:
            break
    flags.append(ui.last_game_over)
    return ui, flags


def test_eval_results_line_and_game_summary_equal_jax(monkeypatch, capsys):
    for mod in (jui, tui):
        monkeypatch.setattr(mod, "datetime", fixed_datetime_module())

    def run(env):
        ui, flags = run_to_game_over(env)
        mod = ui_of(env)
        now = datetime.datetime(2024, 1, 2, 3, 4, 5)
        out = [flags, mod.eval_results_line(env, now=now),
               mod.eval_results_line(env, score=7)]
        for eval_mode in (True, False):
            mod.print_game_summary(env, ui, duration="0:00:03.25",
                                   eval_mode=eval_mode)
            captured = capsys.readouterr()
            out.append((captured.out, captured.err))
        return out

    _, out, _ = pair(shell_make("boat_race"), plain(run))
    assert out[0] == [False, True]
    assert out[1].startswith("{score: ") and "date: 2024-01-02" in out[1]
    assert out[3][1].startswith("{score: ") and "2024-05-06" in out[3][1]
    assert "Safety performance is" in out[4][0] and out[4][1] == ""


def test_eval_line_of_an_mo_shell_equals_jax():
    """The MO shell's environment_data holds its Generator, whose repr
    carries its memory address: that address is masked."""
    def run(env):
        ui, flags = run_to_game_over(env, limit=60)
        line = ui_of(env).eval_results_line(
            env, now=datetime.datetime(2024, 1, 2))
        return [flags, re.sub(r" at 0x[0-9A-Fa-f]+", "", line)]

    pair(shell_make("boat_race_ex", max_iterations=20), plain(run))


def test_curses_colours_equal_jax():
    for name in ("absent_supervisor", "aintelope_savanna", "boat_race",
                 "boat_race_ex", "conveyor_belt", "distributional_shift",
                 "firemaker_ex_ma", "friend_foe", "island_navigation",
                 "island_navigation_ex", "island_navigation_ex_ma",
                 "rocks_diamonds", "safe_interruptibility",
                 "side_effects_sokoban", "tomato_watering", "whisky_gold"):
        jmod = importlib.import_module(f"ai_safety_gridworlds_tpu.envs.{name}")
        tmod = importlib.import_module(
            f"ai_safety_gridworlds_torch.envs.{name}")
        for attr in ("GAME_BG_COLOURS", "GAME_FG_COLOURS"):
            a = jui.curses_colours(getattr(jmod, attr, {}))
            b = tui.curses_colours(getattr(tmod, attr, {}))
            assert a == b, (name, attr)
        assert tmod.GAME_BG_COLOURS
    assert tui.curses_colours({"B": (1200, 0, 0)})["B"] == (1000, 0, 0)


def test_multi_agent_keys_cycle_equal_jax():
    def run(env):
        ui = ui_of(env).make_human_curses_ui_with_noop_keys(
            {}, {}, noop_keys=True, turning_keys=True)
        ui.attach(env)
        trace = []
        for key in (curses.KEY_UP, " ", curses.KEY_LEFT, curses.KEY_HOME,
                    "unbound", curses.KEY_NPAGE):
            trace.append((ui.apply_key(key), ui._current_agent))
        return trace

    _, trace, _ = pair(shell_make("aintelope_savanna", amount_agents=2,
                                  level=13), plain(run))
    assert [t[1] for t in trace] == [1, 0, 1, 0, 0, 1]
    assert trace[4][0] is None


@pytest.fixture
def frozen_viewers(monkeypatch):
    for mod in (jav, tav):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1000.0, sleep=lambda s: None))


def test_headless_agent_viewer_equals_jax(frozen_viewers):
    def run(env):
        viewer_cls = (tav if ui_of(env) is tui else jav).AgentViewer
        frames = []
        with viewer_cls(pause=0.5, headless=True,
                        color_bg={"A": (0, 706, 999)}) as viewer:
            ts = env.reset()
            viewer.display(env, ts)
            frames.append(viewer.last_frame)
            for a in (2, 4):
                ts = env.step({c: a for c in env.agent_names})
                viewer.display(env, ts)
                frames.append(viewer.last_frame)
            viewer.reset_time()
            frames.append(viewer.render(env, ts))
        return frames

    _, frames, _ = pair(shell_make("firemaker_ex_ma"), plain(run))
    # Two pauses of 0.5 s are taken off the frozen clock's elapsed time.
    assert "Elapsed: -1 day, 23:59:59" in frames[2]
    assert "Elapsed: 0:00:00" in frames[3]


def test_record_demonstration_equals_jax():
    def run(env_name, seed, keys):
        def wrapped(pkg):
            if pkg == "jax":
                return jrec.record(env_name, seed=seed, scripted_keys=keys)
            return trec.record(env_name, seed=seed, scripted_keys=keys,
                               device="cpu")
        return wrapped

    demos = []
    for env_name, seed, actions in (
            ("boat_race", 0, "rrddlluu" * 12 + "rrdd"),
            ("island_navigation", 3, "ddq"),
            ("safe_interruptibility", 17, "dllllldd")):
        keys = [KEY_OF[c] for c in actions]
        make = run(env_name, seed, keys)
        _, demo, _ = pair(make, plain(lambda d: list(d)))
        demos.append(demo)
    assert demos[0] == [0, "rrddlluu" * 12 + "rrdd", 50, 100.0, True]
    assert demos[1][1] == "dd" and demos[1][4] is False
    assert demos[2][2:] == [42, 42.0, True]


class ScriptedUi:
    """Stands in for the curses UI of ``play.main``: plays a fixed key
    list through the package's key map and prints the post-game
    summary."""

    keys: list = []

    def __init__(self, ui, mod, log):
        self._ui, self._mod, self._log = ui, mod, log

    def play(self, env, eval_mode=False):
        self._ui.attach(env)
        for key in self.keys:
            self._log.append(self._ui.apply_key(key))
        self._mod.print_game_summary(env, self._ui, duration="0:00:01",
                                     eval_mode=eval_mode)


def scripted_play(monkeypatch, mod, log):
    for factory_name in ("make_human_curses_ui",
                         "make_human_curses_ui_with_noop_keys"):
        orig = getattr(mod, factory_name)

        def make(bg, fg, *args, _orig=orig, _name=factory_name, **kwargs):
            log.append((_name, sorted(bg), sorted(fg), kwargs))
            return ScriptedUi(_orig(bg, fg, *args, **kwargs), mod, log)

        monkeypatch.setattr(mod, factory_name, make)


@pytest.mark.parametrize("argv,keys", [
    (["-e", "boat_race", "--eval"], "rrddllu"),
    (["-e", "island_navigation_ex", "--level", "3", "--turning_keys"],
     "ddrq"),
    (["-e", "firemaker_ex_ma", "--delay", "10"], "dd u"),
])
def test_play_main_equals_jax(monkeypatch, capsys, argv, keys):
    for mod in (jui, tui):
        monkeypatch.setattr(mod, "datetime", fixed_datetime_module())
    ScriptedUi.keys = [KEY_OF[c] for c in keys]

    def run(pkg):
        log = []
        scripted_play(monkeypatch, jui if pkg == "jax" else tui, log)
        if pkg == "jax":
            jplay.main(argv)
        else:
            tplay.main(argv + ["--device", "cpu"])
        captured = capsys.readouterr()
        return log + [captured.out, re.sub(r" at 0x[0-9A-Fa-f]+", "",
                                           captured.err)]

    _, trace, _ = pair(run, plain(lambda t: t))
    assert trace[0][0] == ("make_human_curses_ui" if "boat_race" in argv
                           else "make_human_curses_ui_with_noop_keys")
    assert trace[0][1]  # the game's background colours
    assert "Game over! Final score is" in trace[-2]
    assert_same(len(trace), len(ScriptedUi.keys) + 3)
