"""The MO shell's CSV log and arguments file against the JAX package's, on
the CPU: every ``LOG_*`` column on (``tiletype_qvalue`` after
``set_current_q_value_per_action``, ``metric`` on island_navigation_ex),
both packages writing to separate directories under one ticking clock
(each run's clock starts at the same instant and moves one second a read).
With the package name substituted, the file names and the bytes of the
``.csv`` and ``-arguments-*.txt`` files must be equal; the ``gzip_log``
files must be equal once decompressed (the gzip header holds the time of
writing). Every handle is closed by the fixture."""

import datetime
import gzip
import types

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_mo_shell import fresh_statics  # noqa: F401

COLUMNS = [getattr(jmo, k) for k in dir(jmo)
           if k.startswith("LOG_") and k != "LOG_COMPRESSLEVEL"]


def ticking_clock():
    """A stand-in for the ``datetime`` module whose ``now()`` starts at a
    fixed instant and moves one second a call."""
    start = datetime.datetime(2024, 5, 6, 7, 8, 9)
    calls = [0]

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            calls[0] += 1
            t = start + datetime.timedelta(seconds=calls[0])
            return cls(t.year, t.month, t.day, t.hour, t.minute, t.second)

    return types.SimpleNamespace(datetime=Clock)


def log_run(mod, factory, name, kw, log_dir, monkeypatch, gzip_log, **shell):
    """One seeded run with every column: two resets (the second opens the
    log), two episodes with Q values, a new layout, then a new experiment
    (a second log file)."""
    monkeypatch.setattr(mod, "datetime", ticking_clock())
    mod.reset_class_statics()
    env = mod.SafetyEnvironmentMo(
        factory.get_raw_env(name, **kw), seed=6, log_columns=COLUMNS,
        log_dir=str(log_dir), log_arguments={"level": kw.get("level"),
                                             "note": "x;y"},
        log_filename_comment="cmt", gzip_log=gzip_log,
        flags_dict={"flag_a": 1, "flag_b": [1, 2]}, **shell)
    n_dims = len(env.enabled_reward_dimension_keys)
    n_actions = env._game.action_max - env._game.action_min + 1
    rng = np.random.default_rng(8)
    # A log opens on a reset that follows a reset.
    for resets in ([{}, {}], [{}], [{"env_layout_seed": 2}],
                   [{"start_new_experiment": True}, {}]):
        for reset_kw in resets:
            env.reset(**reset_kw)
        for _ in range(60):
            # Q values at ten digits and beyond, halves included.
            q = np.round(rng.normal(size=(n_actions, n_dims)) * 1e3, 7)
            q[0, 0] = 0.125
            env.set_current_q_value_per_action(list(q))
            if env.step(int(rng.integers(env._game.action_min,
                                         env._game.action_max + 1))).last():
                break
    env.close()
    return env


def read_dir(path, opener=open, rename=lambda s: s):
    out = {}
    for p in sorted(path.iterdir()):
        if p.suffix == ".gz":
            with gzip.open(p, "rb") as f:
                out[rename(p.name)] = rename(f.read().decode("utf-8"))
        else:
            out[rename(p.name)] = rename(p.read_bytes().decode("utf-8"))
    return out


def to_jax_name(s):
    return s.replace("ai_safety_gridworlds_torch", "ai_safety_gridworlds_tpu")


@pytest.mark.parametrize("name,kw,gzip_log", [
    ("island_navigation_ex", {"level": 9}, False),
    ("island_navigation_ex", {"level": 2, "thirst_hunger_death": True}, True),
    ("boat_race_ex", {"level": 1}, False),
    ("conveyor_belt_ex", {"variant": "sushi_goal"}, True),
    ("safe_interruptibility_ex", {"level": 0}, False),
])
def test_csv_and_arguments_files_equal_jax(name, kw, gzip_log, tmp_path,
                                           monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    log_run(jmo, jfactory, name, kw, jdir, monkeypatch, gzip_log)
    log_run(tmo, tfactory, name, kw, tdir, monkeypatch, gzip_log,
            device="cpu")
    jfiles = read_dir(jdir)
    tfiles = read_dir(tdir, rename=to_jax_name)
    assert sorted(jfiles) == sorted(tfiles)
    # Two experiments: two logs and two arguments files.
    assert len(jfiles) == 4
    for fname, text in jfiles.items():
        assert tfiles[fname] == text, fname
    logs = [t for f, t in jfiles.items() if "-arguments-" not in f]
    rows = [line.split(";") for t in logs for line in t.splitlines()]
    assert len(rows) > 20
    # The columns that only this configuration fills are there.
    header = logs[0].splitlines()[0]
    assert "tiletype_qvalue_" in header
    if name == "island_navigation_ex":
        assert "metric_DrinkSatiation" in header
    if not gzip_log:
        # The uncompressed files are byte-equal as written.
        for p in sorted(jdir.iterdir()):
            q = tdir / to_jax_name(p.name).replace(
                "ai_safety_gridworlds_tpu", "ai_safety_gridworlds_torch")
            assert to_jax_name(q.read_bytes().decode("utf-8")).encode(
                "utf-8") == p.read_bytes()


def test_column_vocabulary_equals_jax():
    tcols = sorted(getattr(tmo, k) for k in dir(tmo)
                   if k.startswith("LOG_") and k != "LOG_COMPRESSLEVEL")
    assert tcols == sorted(COLUMNS)
    assert tmo.LOG_COMPRESSLEVEL == jmo.LOG_COMPRESSLEVEL
    for k in dir(jmo):
        v = getattr(jmo, k)
        if k.isupper() and isinstance(v, str):
            assert getattr(tmo, k) == v, k
