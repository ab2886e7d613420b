"""The port's profiling harness (``utils/profiling.py``) on the CPU, tiny
sizes: the port form of ``tests/test_profiling.py``, the trace context, and
the refusal of a missing card."""

import json
import os

import pytest
import torch

from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
from ai_safety_gridworlds_torch.utils.profiling import (
    measure_steps_per_second,
    per_step_latency,
    trace,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_measure_steps_per_second():
    stats = measure_steps_per_second(
        BoatRace(), batch_size=64, n_steps=32, n_reps=2, device="cpu"
    )
    assert stats["steps_per_sec"] > 0
    assert stats["total_steps"] == 2 * 32 * 64
    assert stats["device"] == "cpu" and "device_time_s" not in stats
    assert len(stats["rep_steps_per_sec"]) == 2
    assert stats["min"] <= stats["steps_per_sec"] <= stats["max"]


def test_measure_steps_per_second_calibrates_reps():
    stats = measure_steps_per_second(
        BoatRace(), batch_size=8, n_steps=4, n_reps=1, min_rep_wall_s=0.05,
        include_observation=False, device="cpu")
    assert stats["chunks_per_rep"] > 1
    assert stats["total_steps"] == stats["chunks_per_rep"] * 4 * 8


def test_per_step_latency():
    stats = per_step_latency(BoatRace(), n_steps=10, device="cpu")
    assert stats["seconds_per_step"] > 0 and stats["steps"] == 10


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        per_step_latency(BoatRace(), n_steps=2, device="cpu")
    names = {e.key for e in prof.key_averages()}
    assert any(n.startswith("aten::") for n in names)
    path = tmp_path / f"trace_{os.getpid()}.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_steps_per_second(BoatRace(), batch_size=2, n_steps=1,
                                 n_reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        per_step_latency(BoatRace(), n_steps=1)
