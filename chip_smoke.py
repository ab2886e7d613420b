#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build the port's CUDA kernels from this checkout (``nvcc``, ``sm_90a``);
3. K2 ``prf_words`` against the plain PyTorch PRF, bit for bit, over a
   random grid of 2**20 + 8 words (uint32 edge values included);
4. K1 ``fused_firemaker_rollout`` against the plain PyTorch rollout on the
   card, every state field exactly equal, from ``init_packed(seed, 4096)``:
   the default config for 600 steps (``max_iterations=1000`` truncates at
   step 500, so the run crosses an auto-reset) and
   ``action_direction_mode=1, max_iterations=40`` for 100 steps; and the
   default config for 200 steps from a seeded mid-episode state (burning
   board, busy counters, draw counters across the uint32 wrap);
5. the main path: ``BatchedEnv("firemaker_ex_ma", batch_size=4096,
   device="cuda").rollout(256)`` three times with the launch counters set
   to 0 just before and read just after; then env-steps/s, the plain
   version's time at the same shape, and K1's time by lane count (4096,
   16384, 65536) and lane tile (32, 64, 128, 256);
6. one JSON line of kernel results: ``kernels`` holds the main path's
   kernel (K1) with its launches from phase 5; ``checked_off_path`` holds
   K2, which the main path does not launch (K1 inlines the same PRF header),
   with its phase-5 launches (0) and its phase-3 launches; then the card's
   name and power limit and the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BATCH = 4096
MAIN_STEPS = 256
MAIN_CALLS = 3
SEED = 0
SWEEP_BATCHES = (BATCH, 4 * BATCH, 16 * BATCH)
TILES = (32, 64, 128, 256)
# (label, env kwargs, steps, start): "init" is init_packed(SEED, BATCH),
# "busy" is interop.busy_firemaker_state(fused, SEED, BATCH).
K1_CHECKS = (
    ("default", {}, 600, "init"),
    ("adm1_maxit40", {"action_direction_mode": 1, "max_iterations": 40}, 100,
     "init"),
    ("default_busy", {}, 200, "busy"),
)
K1_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:432 (_rollout_pallas_call) "
    "x ai_safety_gridworlds_tpu/ops/fused_firemaker.py:373 (_step)"
)
K2_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/prng.py:44 (hash_u32), :63 (uniform01)"
)


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.ops import _cuda, interop, prng
    from ai_safety_gridworlds_torch.ops.fused_firemaker import (
        FusedFiremaker,
        fused_firemaker_rollout,
    )

    dev = torch.device("cuda", 0)
    card = gpu_line()

    # ---- 1. environment
    log("== 1. environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = _cuda.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    log(f"nvcc {nvcc}: {ver[-1]}")
    try:
        import triton

        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    log(f"card: {card}  (device count {torch.cuda.device_count()}, "
        f"{torch.cuda.get_device_name(0)})")
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    log("== 2. build")
    t0 = time.perf_counter()
    logs = _cuda.build()
    log(f"built {sorted(logs)} into {_cuda.build_dir()} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")

    # ---- 3. K2 against the plain PRF
    log("== 3. K2 prf_words vs plain hash_u32/uniform01")
    rng = np.random.default_rng(SEED)
    n_words = (1 << 20) + 8
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, 7, 11],
                    np.uint32)
    grid = []
    for _ in range(4):
        g = rng.integers(0, 2**32, size=n_words, dtype=np.uint32)
        g[:8] = rng.permutation(edge)
        grid.append(torch.from_numpy(g).to(dev))
    prng.prf_words.launches = 0
    words, u = prng.prf_words(*grid)
    words_p = prng.hash_u32(*grid)
    u_p = prng.uniform01(words_p)
    torch.cuda.synchronize()
    if not torch.equal(words.to(torch.int64), words_p.to(torch.int64)):
        fail("K2 words differ from the plain PRF")
    if not torch.equal(u, u_p):
        fail("K2 uniforms differ from the plain PRF")
    k2_err = float((u - u_p).abs().max())
    k2_ms = cuda_ms(lambda: prng.prf_words(*grid), 20, torch)
    k2_plain_ms = cuda_ms(
        lambda: prng.uniform01(prng.hash_u32(*grid)), 5, torch
    )
    k2_check_launches = prng.prf_words.launches
    log(f"K2 equal over {n_words} words; {k2_ms:.4f} ms vs plain "
        f"{k2_plain_ms:.4f} ms  [{card}]")

    # ---- 4. K1 against the plain rollout on the card
    log("== 4. K1 fused_firemaker_rollout vs plain rollout")
    k1_err = 0.0
    for label, kw, steps, start in K1_CHECKS:
        fused = FusedFiremaker(FiremakerExMa(**kw))
        if start == "init":
            S0 = fused.init_packed(SEED, BATCH, dev)
        else:
            S0 = interop.busy_firemaker_state(fused, SEED, BATCH, dev)
        t0 = time.perf_counter()
        Sk = fused.rollout(S0, steps)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        Sp = fused.rollout_plain(S0, steps)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        for k in fused.STATE_FIELDS:
            a, b = Sk[k], Sp[k]
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"K1 {label}: field {k} dtype/shape differs")
            if not a.is_floating_point():
                a, b = a.to(torch.int64), b.to(torch.int64)
            if not torch.equal(a, b):
                lanes = (a != b).any(dim=0).nonzero().flatten()[:8].tolist()
                fail(f"K1 {label}: field {k} differs (lanes {lanes}...)")
            if a.is_floating_point():
                k1_err = max(k1_err, float((a - b).abs().max()))
        eps = Sk["stats_episodes"]
        fires = int((Sk["fire"] > 0.5).sum())
        log(f"K1 {label}: {steps} steps equal in all "
            f"{len(fused.STATE_FIELDS)} fields; episodes per lane "
            f"{int(eps.min())}..{int(eps.max())}, burning cells {fires}; "
            f"kernel {tk:.3f} s, plain {tp:.3f} s")
        if label == "default" and int(eps.min()) < 1:
            fail("K1 default check did not cross an auto-reset")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail("K1 busy check did not cross the draw-counter wrap")
        if not all(torch.isfinite(Sk[k]).all() for k in ("fire", "stats_rewards")):
            fail(f"K1 {label}: non-finite values")

    # ---- 5. the main path
    log("== 5. main path: BatchedEnv('firemaker_ex_ma', 4096, device='cuda')")
    env = BatchedEnv("firemaker_ex_ma", batch_size=BATCH, seed=SEED,
                     device="cuda")
    if env.kernel != "fused_cuda":
        fail(f"BatchedEnv reports kernel {env.kernel!r}")
    fused = env.fused
    S_start = {k: v.clone() for k, v in env.state.items()}
    torch.cuda.synchronize()
    fused_firemaker_rollout.launches = 0
    prng.prf_words.launches = 0
    call_s, episodes = [], 0
    for call in range(MAIN_CALLS):
        t0 = time.perf_counter()
        stats = env.rollout(MAIN_STEPS)  # fetches stats: synchronises
        call_s.append(time.perf_counter() - t0)
        episodes += stats["episodes"]
        if fused_firemaker_rollout.launches != call + 1:
            fail("K1 launch count did not rise by one per rollout call")
        if stats["steps"] != BATCH * MAIN_STEPS or stats["kernel"] != "fused_cuda":
            fail(f"bad stats {stats}")
        if not np.isfinite(stats["sum_rewards"]).all():
            fail("non-finite reward sums")
    launches = {
        "fused_firemaker_rollout": fused_firemaker_rollout.launches,
        "prf_words": prng.prf_words.launches,
    }
    log(f"launch counts over the main path: {launches}")
    if launches["fused_firemaker_rollout"] != MAIN_CALLS:
        fail("K1, the main path's kernel, was not launched once per call")
    # 768 steps with t advancing 2 per step: every lane ends exactly one
    # episode (truncation at step 500) and starts the next.
    if episodes != BATCH:
        fail(f"expected {BATCH} finished episodes over the main path, got {episodes}")
    for call, s in enumerate(call_s):
        log(f"rollout call {call}: {s * 1e3:.3f} ms host clock, "
            f"{BATCH * MAIN_STEPS / s:.0f} env-steps/s  [{card}]")

    k1_ms = cuda_ms(lambda: fused.rollout(S_start, MAIN_STEPS), 3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_plain(S_start, MAIN_STEPS)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    log(f"K1 rollout({MAIN_STEPS}) at B={BATCH}: {k1_ms:.3f} ms "
        f"({BATCH * MAIN_STEPS / k1_ms * 1e3:.0f} env-steps/s); plain "
        f"{k1_plain_ms:.3f} ms ({BATCH * MAIN_STEPS / k1_plain_ms * 1e3:.0f} "
        f"env-steps/s)  [{card}]")
    # K1 alone by lane count and tile, from init_packed (3 timed calls each).
    for b in SWEEP_BATCHES:
        S_b = fused.init_packed(SEED, b, dev)
        for tile in TILES:
            ms = cuda_ms(lambda: fused.rollout(S_b, MAIN_STEPS, tile=tile), 3,
                         torch)
            log(f"K1 sweep: rollout({MAIN_STEPS}) B={b} tile={tile}: "
                f"{ms:.3f} ms, {b * MAIN_STEPS / ms * 1e3:.0f} env-steps/s  "
                f"[{card}]")
        del S_b

    # ---- 6. results
    kernels = [{
        "name": "fused_firemaker_rollout", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_firemaker.cu",
        "replaces": K1_REPLACES,
        "launches": launches["fused_firemaker_rollout"],
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
    }]
    checked_off_path = [{
        "name": "prf_words", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/prf_words.cu",
        "replaces": K2_REPLACES,
        "launches": launches["prf_words"],
        "check_launches": k2_check_launches,
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
    }]
    log(json.dumps({"kernels": kernels, "checked_off_path": checked_off_path}))
    log(gpu_line())
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
