"""Step-rate measurement and profiler hooks.

Port of ``ai_safety_gridworlds_tpu/utils/profiling.py``: a self-contained
harness that times batched auto-resetting rollouts of the generic path
(``core/base.py``: ``episode_reset``, ``episode_step``) on a device, the
first call excluded, and a ``torch.profiler`` trace context for inspecting a
measured region.

PyTorch returns to the host before the device has run what was issued, so
every timed region ends in a host fetch of a scalar (``float(acc)``), as the
JAX package's harness ends its own; on a card, CUDA events recorded around
each region give the device's time beside the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ai_safety_gridworlds_torch.core import base as core_base
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.ops import resolve_device


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


class _Clock:
    """Host seconds of a region ending in a host fetch, and on a card the
    device's seconds between two CUDA events around it."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def stop(self, acc: torch.Tensor) -> None:
        """End the region: record the end event, then fetch ``acc``."""
        if self.cuda:
            self.end.record()
        float(acc)
        self.wall = time.perf_counter() - self.t0
        self.device_s = (self.start.elapsed_time(self.end) / 1e3
                         if self.cuda else None)

    def __exit__(self, *exc):
        return False


def measure_steps_per_second(
    env,
    batch_size: int = 4096,
    n_steps: int = 2048,
    n_reps: int = 3,
    include_observation: bool = True,
    key=None,
    min_rep_wall_s: float = 0.0,
    device="cuda",
) -> dict:
    """Aggregate env steps/s of a batched auto-resetting rollout on
    ``device`` (the card unless the caller asks for the CPU).

    One chunk of ``n_steps`` runs first, untimed; then ``n_reps`` reps are
    timed one by one, each ``chunks_per_rep`` chunks issued without a
    synchronisation and ended by a host fetch. ``min_rep_wall_s`` > 0 sizes
    ``chunks_per_rep`` from one timed chunk so that a rep lasts at least that
    long. Each step draws every lane's action from the step's key and adds
    the rewards (and, with ``include_observation``, the rendered boards) to
    a device accumulator.

    Returns the JAX package's keys (``steps_per_sec`` the median of
    ``rep_steps_per_sec``, ``min``, ``max``, ``wall_time_s``,
    ``total_steps`` and the configuration) with ``device`` the card's name,
    and on a card ``rep_device_steps_per_sec`` and ``device_time_s`` from
    CUDA events."""
    dev = resolve_device(device)
    key = (threefry.PRNGKey(0, dev) if key is None
           else torch.as_tensor(key).to(dev))

    def chunk(ep, chunk_key):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for step_key in threefry.split(chunk_key, n_steps):
            actions = threefry.randint(step_key, (batch_size,),
                                       env.action_min, env.action_max + 1)
            ep, outs = core_base.episode_step(env, ep, actions)
            acc = acc + outs.step.reward.sum()
            if include_observation:
                acc = acc + env.observe(ep.env_state)["board"].sum(
                    dtype=torch.float32)
        return ep, acc

    keys = threefry.split(key, batch_size + 1)
    ep = core_base.episode_reset(env, keys[1:])
    ep, acc = chunk(ep, keys[0])  # warm-up
    float(acc)

    chunks_per_rep = 1
    if min_rep_wall_s > 0:
        t0 = time.perf_counter()
        ep, acc = chunk(ep, threefry.fold_in(keys[0], 10**6))
        float(acc)
        chunk_wall = max(time.perf_counter() - t0, 1e-9)
        chunks_per_rep = max(1, int(min_rep_wall_s / chunk_wall) + 1)

    rep_rates, device_rates, wall_total, device_total = [], [], 0.0, 0.0
    steps_per_rep = chunks_per_rep * n_steps * batch_size
    for i in range(n_reps):
        with _Clock(dev) as clock:
            for j in range(chunks_per_rep):
                ep, acc = chunk(
                    ep, threefry.fold_in(keys[0], i * chunks_per_rep + j))
            clock.stop(acc)
        wall_total += clock.wall
        rep_rates.append(steps_per_rep / clock.wall)
        if clock.device_s is not None:
            device_total += clock.device_s
            device_rates.append(steps_per_rep / clock.device_s)

    sorted_rates = sorted(rep_rates)
    out = {
        "steps_per_sec": sorted_rates[len(sorted_rates) // 2],
        "rep_steps_per_sec": rep_rates,
        "min": sorted_rates[0],
        "max": sorted_rates[-1],
        "wall_time_s": wall_total,
        "total_steps": n_reps * steps_per_rep,
        "batch_size": batch_size,
        "n_steps": n_steps,
        "n_reps": n_reps,
        "chunks_per_rep": chunks_per_rep,
        "include_observation": include_observation,
        "device": _device_name(dev),
    }
    if device_rates:
        out["rep_device_steps_per_sec"] = device_rates
        out["device_time_s"] = device_total
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the region (CPU and, with a card, CUDA
    activity), written on exit as a Chrome trace into ``log_dir``
    (``trace_<pid>.json``). Yields the profiler, whose ``key_averages()``
    sum the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def per_step_latency(env, n_steps: int = 100, key=None, device="cuda") -> dict:
    """One lane's step latency on ``device`` (what a human or a
    single-stream agent pays a step), in seconds per step: ``n_steps``
    auto-resetting steps of the first action after one untimed step, ended
    by a host fetch; on a card also the device's seconds per step."""
    dev = resolve_device(device)
    key = (threefry.PRNGKey(0, dev) if key is None
           else torch.as_tensor(key).to(dev))
    ep = core_base.episode_reset(env, key.view(1, 2))
    action = torch.full((1,), int(env.action_min), dtype=torch.int32,
                        device=dev)
    ep, out = core_base.episode_step(env, ep, action)
    float(out.step.reward.sum())
    with _Clock(dev) as clock:
        for _ in range(n_steps):
            ep, out = core_base.episode_step(env, ep, action)
        clock.stop(out.step.reward.sum())
    result = {"seconds_per_step": clock.wall / n_steps, "steps": n_steps,
              "device": _device_name(dev)}
    if clock.device_s is not None:
        result["device_seconds_per_step"] = clock.device_s / n_steps
    return result
