"""The multi-agent shell's CSV log and arguments file against the JAX
package's, on the CPU: every ``LOG_*`` column on, flattened
(``<column>_<agent>[_<dim>]``) and in the reference's layout
(``reference_csv_format=True``: agent-name cells, ``str(dict)`` cells, the
Q values per tile type as the reference writes them), with per-agent Q
values from ``set_current_q_value_per_action`` or without. Both packages
write to separate directories under one ticking clock (each run's clock
starts at the same instant and moves one second a read). With the package
name substituted, the file names and the bytes of the ``.csv`` and
``-arguments-*.txt`` files must be equal (``gzip_log`` files once
decompressed). Where the island's regrowth rule exempts a step (the
harness's ``GAP``), the rows from that step on are left out of the
comparison and counted; no configuration here meets one."""

import datetime

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.ma import safety_game_moma as jmoma
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.ma import safety_game_moma as tmoma
from ai_safety_gridworlds_torch.mo import map_randomization as tmr
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_mo_csv import read_dir, to_jax_name
from test_torch_moma_shell import (  # noqa: F401
    GAP,
    LAST,
    DEAD,
    fresh_statics,
    step_gap,
)
from torch_threads import one_torch_thread  # noqa: F401

COLUMNS = [getattr(jmo, k) for k in dir(jmo)
           if k.startswith("LOG_") and k != "LOG_COMPRESSLEVEL"]


def ticking_clock():
    """A ``datetime.datetime`` whose ``now()`` starts at a fixed instant
    and moves one second a call."""
    start = datetime.datetime(2024, 5, 6, 7, 8, 9)
    calls = [0]

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            calls[0] += 1
            t = start + datetime.timedelta(seconds=calls[0])
            return cls(t.year, t.month, t.day, t.hour, t.minute, t.second)

    return Clock


def log_run(shell, mo, mr, factory, name, kw, log_dir, monkeypatch, q_values,
            **shell_kw):
    """One seeded run with every column: two resets (the second opens the
    log), two episodes, a new layout, then a new experiment (a second log
    file); per-agent Q values before each step when ``q_values``. Returns
    the shell and the number of rows written before the first step the
    regrowth rule exempts (None if none)."""
    monkeypatch.setattr(datetime, "datetime", ticking_clock())
    mo.reset_class_statics()
    mr.clear_randomization_cache()
    game = factory.get_raw_env(name, **kw)
    if hasattr(game, "regrow_gaps"):
        game.regrow_gaps = []
    env = shell(
        game, seed=6, log_columns=COLUMNS, log_dir=str(log_dir),
        log_arguments={"name": name, "note": "x;y"},
        log_filename_comment="cmt", flags_dict={"flag_a": 1, "flag_b": [1]},
        **shell_kw)
    n_actions = game.action_max - game.action_min + 1
    rng = np.random.default_rng(8)
    rows, exempt_at = 0, None
    for resets in ([{}, {}], [{}], [{"env_layout_seed": 2}],
                   [{"start_new_experiment": True}, {}]):
        for reset_kw in resets:
            ts = env.reset(**reset_kw)
        step_gap(env)
        for _ in range(12):
            if q_values:
                q = {a: np.round(rng.normal(size=(
                    n_actions, len(env.enabled_agents_reward_dimensions[a])))
                    * 1e3, 7) for a in env.agent_names}
                env.set_current_q_value_per_action(q)
            acts = {a: int(rng.integers(game.action_min, game.action_max + 1))
                    for a in env.agent_names
                    if int(ts.step_type[a]) not in (LAST, DEAD)}
            if not acts:
                break
            ts = env.step(acts)
            rows += 1
            if exempt_at is None and step_gap(env) <= GAP:
                exempt_at = rows
    env.close()
    return env, exempt_at


CONFIGS = [
    ("firemaker_ex_ma", {"max_iterations": 10}, {}, True),
    ("firemaker_ex_ma", {"max_iterations": 10},
     {"reference_csv_format": True, "gzip_log": True}, True),
    ("island_navigation_ex_ma",
     {"level": 8, "max_iterations": 9,
      "GAP_REWARD": "{'FOOD_REWARD': 0.5, 'DRINK_REWARD': -0.25}",
      "NON_DRINK_REWARD": "{'DRINK_REWARD': -0.5}"},
     {"reference_csv_format": True}, False),
    ("island_navigation_ex_ma",
     {"level": 3, "sustainability_challenge": True,
      "penalise_oversatiation": True,
      "use_satiation_proportional_reward": True, "max_iterations": 10},
     {}, True),
    ("aintelope_savanna",
     {"amount_agents": 2, "amount_drink_holes": 2,
      "penalise_oversatiation": True,
      "use_satiation_proportional_reward": True, "max_iterations": 10},
     {"reference_csv_format": True}, True),
    ("aintelope_savanna",
     {"amount_agents": 2, "amount_predators": 2, "max_iterations": 10},
     {"scalarise": True}, False),
]


@pytest.mark.parametrize("name,kw,shell_kw,q_values", CONFIGS,
                         ids=["firemaker", "firemaker_ref", "island_ref",
                              "island_sustain", "savanna_ref",
                              "savanna_scalar"])
def test_csv_and_arguments_files_equal_jax(name, kw, shell_kw, q_values,
                                           tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    log_run(jmoma.SafetyEnvironmentMoMa, jmo, jmr, jfactory, name, kw, jdir,
            monkeypatch, q_values, **shell_kw)
    tenv, exempt_at = log_run(
        tmoma.SafetyEnvironmentMoMa, tmo, tmr, tfactory, name, kw, tdir,
        monkeypatch, q_values, device="cpu", **shell_kw)
    assert exempt_at is None
    jfiles = read_dir(jdir)
    tfiles = read_dir(tdir, rename=to_jax_name)
    assert sorted(jfiles) == sorted(tfiles)
    # Two experiments: two logs and two arguments files.
    assert len(jfiles) == 4
    for fname, text in jfiles.items():
        assert tfiles[fname] == text, fname
    logs = [t for f, t in jfiles.items() if "-arguments-" not in f]
    rows = [line for t in logs for line in t.splitlines()]
    assert len(rows) > 20
    header = logs[0].splitlines()[0]
    if shell_kw.get("reference_csv_format"):
        assert "reward_" + tenv.agent_names[0] + ";" in header + ";"
    else:
        a = tenv.agent_names[0]
        assert "reward_" + a + "_" + tenv.enabled_agents_reward_dimensions[
            a][0] in header
    if q_values and not shell_kw.get("reference_csv_format"):
        assert "tiletype_qvalue_" + tenv.agent_names[0] + "_" in header
    if not shell_kw.get("gzip_log"):
        # The uncompressed files are byte-equal as written.
        for p in sorted(jdir.iterdir()):
            q = tdir / p.name.replace("ai_safety_gridworlds_tpu",
                                      "ai_safety_gridworlds_torch")
            assert to_jax_name(q.read_bytes().decode("utf-8")).encode(
                "utf-8") == p.read_bytes()


def test_reference_py_number_equals_jax():
    jconv = jmoma.SafetyEnvironmentMoMa._reference_py_number
    tconv = tmoma.SafetyEnvironmentMoMa._reference_py_number
    for v in (0.0, -0.0, 3.0, -2.0, 0.5, 1e-9, 20.0, -50.0, 2.5e6):
        for typed in (False, True):
            for touched in (False, True):
                j, t = jconv(v, typed, touched), tconv(v, typed, touched)
                assert (type(j), j) == (type(t), t), (v, typed, touched)
    assert tconv(3.0) == 3 and isinstance(tconv(3.0), int)
    assert isinstance(tconv(0.0, float_touched=True), float)
    assert isinstance(tconv(2.0, float_typed=True), float)
    assert isinstance(tconv(0.0, float_typed=True), int)


@pytest.mark.parametrize("name,kw", [
    ("firemaker_ex_ma", {"amount_agents": 3}),
    ("aintelope_savanna", {"amount_agents": 2, "amount_drink_holes": 2,
                           "use_satiation_proportional_reward": True,
                           "SMALL_FOOD_SCORE": "{'FOOD': 10.5}"}),
    ("island_navigation_ex_ma", {"use_satiation_proportional_reward": True}),
])
def test_float_dims_and_metric_columns_equal_jax(name, kw):
    """The statically float-typed dims and the construction-time metric
    columns of the reference's layout."""
    envs = [
        jmoma.SafetyEnvironmentMoMa(jfactory.get_raw_env(name, **kw), seed=1),
        tmoma.SafetyEnvironmentMoMa(tfactory.get_raw_env(name, **kw), seed=1,
                                    device="cpu"),
    ]
    out = [(e._reference_runtime_float_dims(), e._reference_metrics_keys(),
            e.enabled_agents_reward_dimensions,
            {a: [u.tolist() for u in s]
             for a, s in e.get_reward_unit_space().items()})
           for e in envs]
    assert out[0] == out[1]
