"""The port's fused firemaker step against the JAX package's.

* (a) ``init_packed`` equals JAX's field by field (dtypes included).
* (b) The plain PyTorch rollout is bit-identical (tolerance 0) to JAX's
  product-form step (``FusedFiremaker(env, mxu_stencil=False).step_xla``)
  called eagerly in a loop, for the default config, every valid direction-mode
  pair and a config that crosses auto-resets. Eager JAX is the oracle because
  XLA's fusion under ``jit`` reassociates the stencil's float32 product
  (last-bit differences up to ~3e-8 in ``cum``).
* (c) One step from shared, numpy-seeded states against the jitted JAX
  rollout and the Pallas interpreter: every field equal, except on a lane
  whose fire differs, which must hold a spread draw within 1e-6 of its
  probability (the reassociation above flipping ``u < cum``).
* (d) The log-survival form of the stencil is within 1e-5 of the product
  form and exactly 0 where no neighbour burns; the product form equals
  JAX's eager product form bit for bit.
* (e) The CUDA kernels' geometry, which runs in Python: their table form of
  the stencil equals the product form bit for bit, the launch geometry and
  shared memory, and the refusal of a board past their limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs import firemaker_ex_ma as firemaker_env
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import GAME_ART
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa as TEnv
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker as TF,
    _check_geometry,
    _lanes_per_block,
    _smem_bytes,
    _stencil,
    fused_firemaker_rollout,
)
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa as JEnv
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker as JF
from torch_threads import one_torch_thread  # noqa: F401


def _pair(mxu_stencil=False, **kw):
    return (TF(TEnv(**kw), mxu_stencil=mxu_stencil),
            JF(JEnv(**kw), mxu_stencil=mxu_stencil))


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        want = np.asarray(jS[k])
        got = tS[k].numpy()
        assert got.dtype == want.dtype, f"{msg} {k}: {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize(
    "kw", [{}, {"action_direction_mode": 2, "observation_direction_mode": 1},
           {"amount_agents": 3}],
    ids=["default", "dirs", "three_agents"],
)
def test_init_packed_equal(kw):
    tf, jf = _pair(**kw)
    tS = tf.init_packed(7, 96, "cpu")
    jS = jf.init_packed(seed=7, batch=96)
    assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    assert set(tS) == set(jS)
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)


# ------------------------------------------------------------------ (b)

VALID_MODES = [(a, o) for a in range(3) for o in range(3) if (a, o) != (0, 2)]
CONFIGS = [
    pytest.param({"action_direction_mode": a, "observation_direction_mode": o},
                 id=f"adm{a}_odm{o}")
    for a, o in VALID_MODES
] + [
    pytest.param({"max_iterations": 24}, id="auto_reset"),
    pytest.param({"amount_agents": 3, "max_iterations": 30,
                  "FIRE_CONTINUATION_PROBABILITY": 0.8},
                 id="three_agents_reset"),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_plain_rollout_bit_identical_to_jax_eager(kw):
    tf, jf = _pair(**kw)
    B, n_steps = 32, 50
    tS = tf.init_packed(11, B, "cpu")
    jS = jf.init_packed(seed=11, batch=B)
    for step in range(n_steps):
        jS = jf.step_xla(jS)
        tS = tf.step(tS)
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
    # The run exercised the dynamics it claims to.
    assert np.asarray(jS["t"]).max() > 0
    assert np.abs(np.asarray(jS["stats_rewards"])).sum() > 0
    if "max_iterations" in kw:
        assert np.asarray(jS["stats_episodes"]).min() >= 1


@pytest.mark.parametrize(
    "kw", [{}, {"action_direction_mode": 2, "observation_direction_mode": 1},
           {"amount_agents": 3, "max_iterations": 30}],
    ids=["default", "dirs", "three_agents"],
)
def test_plain_rollout_from_busy_state_bit_identical_to_jax_eager(kw):
    """From ``interop.busy_firemaker_state`` (burning board, busy counters,
    draw counters across the uint32 wrap), the state the on-card test holds
    the kernel against the plain version from."""
    tf, jf = _pair(**kw)
    tS = interop.busy_firemaker_state(tf, 9, 32, "cpu")
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    for step in range(12):
        jS = jf.step_xla(jS)
        tS = tf.step(tS)
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
    assert int(tS["draw_ctr"].to(torch.int64).min()) < 12  # wrapped
    assert tS["fire"].sum() > 0


def test_collected_draws_equal_jax():
    tf, jf = _pair()
    tS = tf.init_packed(2, 24, "cpu")
    jS = jf.init_packed(seed=2, batch=24)
    for step in range(6):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("order", "actions", "rewards", "over"):
            np.testing.assert_array_equal(
                td[k].numpy(), np.asarray(jd[k]), err_msg=f"{step} {k}"
            )
        assert td["pol"] is None and jd["pol"] is None
        for ts, js in zip(td["slots"], jd["slots"]):
            for k in ("spread_cells", "spread_set", "cont_keep"):
                np.testing.assert_array_equal(
                    ts[k].numpy(), np.asarray(js[k]), err_msg=f"{step} {k}"
                )


def test_rollout_on_cpu_is_the_plain_loop():
    tf, _ = _pair(max_iterations=10)
    S0 = tf.init_packed(3, 16, "cpu")
    before = fused_firemaker_rollout.launches
    a = tf.rollout(S0, 12)
    b = tf.rollout_plain(S0, 12)
    c = fused_firemaker_rollout(tf, S0, 12)
    assert fused_firemaker_rollout.launches == before  # no kernel on the CPU
    for k in tf.STATE_FIELDS:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k


def test_log_form_runs_in_the_plain_version():
    """On the CPU the log form runs; on the card it raises
    (``tests/test_torch_cuda.py``)."""
    tf, _ = _pair(mxu_stencil=True)
    S0 = tf.init_packed(3, 8, "cpu")
    a, b = tf.rollout(S0, 4), tf.rollout_plain(S0, 4)
    for k in tf.STATE_FIELDS:
        assert torch.equal(a[k], b[k]), k


def test_interop_round_trip_keeps_dtypes():
    _, jf = _pair()
    jS = {k: np.asarray(v) for k, v in jf.init_packed(seed=1, batch=8).items()}
    back = interop.state_to_numpy(interop.state_from_numpy(jS, "cpu"))
    for k, v in jS.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


# ------------------------------------------------------------------ (c)


def _shared_state(jf, seed, B):
    """A numpy-seeded packed state with burning cells, busy counters and
    wrapped-around draw counters."""
    rng = np.random.default_rng(seed)
    S = {k: np.array(v) for k, v in jf.init_packed(seed=seed, batch=B).items()}
    spreadable = jf.consts["spreadable"][:, 0] > 0.5
    fire = (rng.random((jf.HW, B)) < 0.2) & spreadable[:, None]
    S["fire"] = fire.astype(np.float32)
    S["draw_ctr"] = rng.integers(0, 2**32, size=(1, B), dtype=np.uint32)
    S["t"] = 2 * rng.integers(0, 500, size=(1, B)).astype(np.int32)
    S["countdown"] = rng.integers(0, 5, size=(1, B)).astype(np.int32)
    S["ext_fires"] = rng.integers(0, 3, size=(1, B)).astype(np.int32)
    # Half the lanes: agents on random distinct free cells.
    free = np.flatnonzero(jf.consts["wall"][:, 0] < 0.5)
    for b in range(0, B, 2):
        S["pos"][:, b] = rng.choice(free, size=jf.n, replace=False)
    return S


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_one_step_against_jitted_jax(backend):
    tf, jf = _pair()
    B = 64
    S_np = _shared_state(jf, 21, B)
    kw = {"tile": 32, "interpret": True} if backend == "pallas" else {}
    jS = jf.rollout({k: jnp.asarray(v) for k, v in S_np.items()}, 1,
                    backend=backend, **kw)
    tS, draws = tf.step(interop.state_from_numpy(S_np, "cpu"),
                        collect_draws=True)
    jfire = np.asarray(jS["fire"])
    tfire = tS["fire"].numpy()
    odd = np.flatnonzero((jfire != tfire).any(axis=0))
    for b in odd:
        # A differing lane must hold a near-tie spread draw.
        gaps = [
            np.abs(d["u"].numpy()[:, b] - d["cum"].numpy()[:, b])[
                d["spread_cells"].numpy()[:, b]
            ].min(initial=1.0)
            for d in draws
        ]
        assert min(gaps) <= 1e-6, (b, gaps)
    assert len(odd) <= 2, odd
    keep = np.setdiff1d(np.arange(B), odd)
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(
            tS[k].numpy()[:, keep], np.asarray(jS[k])[:, keep], err_msg=k
        )
    assert tfire.sum() > 0


# ------------------------------------------------------------------ (d)


def test_log_form_cum_accuracy_and_product_form_bits():
    poly_t, poly_j = _pair(mxu_stencil=False)
    mxu_t, mxu_j = _pair(mxu_stencil=True)
    c_poly = {k: jnp.asarray(v) for k, v in poly_j.consts.items()}
    c_mxu = {k: jnp.asarray(v) for k, v in mxu_j.consts.items()}
    rng = np.random.default_rng(0)
    for density in (0.02, 0.1, 0.5, 1.0):
        src = (rng.random((poly_t.HW, 64)) < density).astype(np.float32)
        src_t = torch.from_numpy(src)
        cum_poly = poly_t._spread_cum(src_t, poly_t._on("cpu")).numpy()
        cum_log = mxu_t._spread_cum(src_t, mxu_t._on("cpu")).numpy()
        # Product form: bit-identical to JAX's eager product form.
        np.testing.assert_array_equal(
            cum_poly, np.asarray(poly_j._spread_cum(jnp.asarray(src), c_poly))
        )
        # Log form: within 1e-5 (float32 rounding of a sum of logs).
        np.testing.assert_allclose(cum_log, cum_poly, rtol=0, atol=1e-5,
                                   err_msg=f"density {density}")
        np.testing.assert_allclose(
            cum_log, np.asarray(mxu_j._spread_cum(jnp.asarray(src), c_mxu)),
            rtol=0, atol=1e-5,
        )
        no_nbr = cum_poly == 0.0
        assert (cum_log[no_nbr] == 0.0).all()
        assert (cum_log[~no_nbr] > 0.0).all()


# ------------------------------------------------- the kernels' geometry


def _table_form_cum(fused, src):
    """``1 - prod`` as K1/K3 form it from ``_stencil``'s tables, in numpy
    float32: each row's table entry (its factors q in the terms' order) is
    read at the row's window of the extended, wrapped source board."""
    st = _stencil(fused)
    n_rows, win = len(st["row_base"]), st["win_bits"]
    table = np.ones((n_rows, 1 << win), np.float32)
    for r in range(n_rows):
        for pattern in range(1 << win):
            for row, bit, q in st["terms"]:
                if row == r and (pattern >> bit) & 1:
                    table[r, pattern] = table[r, pattern] * np.float32(q)
    ext = src[(np.arange(st["n_ext"]) + st["ext_lo"]) % fused.HW]
    cum = np.zeros(src.shape, np.float32)
    for c in range(fused.HW):
        prod = np.ones(src.shape[1], np.float32)
        for r in range(n_rows):
            start = c - st["row_base"][r]
            assert start >= 0
            idx = np.zeros(src.shape[1], np.int64)
            for i in range(min(win, st["n_ext"] - start)):
                idx |= ext[start + i].astype(np.int64) << i
            prod = prod * table[r, idx]
        cum[c] = np.float32(1.0) - prod
    return cum


@pytest.mark.parametrize("max_d", [2.0, 3.0, 4.0])
def test_kernel_stencil_tables_equal_the_product_form(max_d):
    """The kernels' stencil (one table entry per row of equal dr, read at
    a window of the extended source board) gives the plain product form's
    cum bit for bit at every cell, wrap-around included."""
    tf, _ = _pair(FIRE_SPREAD_EXCLUSIVE_MAX_DISTANCE=max_d)
    rng = np.random.default_rng(5)
    for density in (0.02, 0.3, 1.0):
        src = (rng.random((tf.HW, 16)) < density).astype(np.float32)
        want = tf._spread_cum(torch.from_numpy(src), tf._on("cpu")).numpy()
        np.testing.assert_array_equal(
            _table_form_cum(tf, src).view(np.uint32), want.view(np.uint32)
        )


def test_launch_geometry():
    """Lanes per block from ``tile`` (threads per block, one warp per
    lane) and the kernels' shared memory, counted by hand for the default
    board: 17 x 17 = 289 cells, 5 stencil rows of 5-bit windows, the
    extended source board 289 + 2 * 36 = 361 bits."""
    tf, _ = _pair()
    assert [_lanes_per_block(t) for t in (32, 64, 128, 256)] == [1, 2, 4, 8]
    st = _stencil(tf)
    assert (len(st["row_base"]), st["win_bits"]) == (5, 5)
    assert (st["ext_lo"], st["n_ext"]) == (-36, 361)
    # Block: reward vectors 8 * 8, table 5 * 32, cell bits 289 / 4 -> 73
    # words; per lane: fire 10, source board 12 + 1 spare.
    block, lane = 64 + 160 + 73, 10 + 13
    assert _smem_bytes(tf, 128) == 4 * (block + 4 * lane)
    # K3 at H = 64, A = 5: w1 384, b1 64, w2 6 rows of 65, b2 6; per lane
    # the hidden units of 2 agents, 65 apart.
    weights = 384 + 64 + 6 * 65 + 6
    assert _smem_bytes(tf, 256, 64) == 4 * (weights + block
                                            + 8 * (lane + 2 * 65))
    _check_geometry(tf, 256, 64)
    with pytest.raises(ValueError, match="shared memory"):
        _check_geometry(tf, 256, 20000)


def _big_art():
    """The firemaker art widened to 33 x 33 = 1089 cells."""
    art = GAME_ART[0]
    rows = [r[:-1] + ("#" if r[0] == r[1] == "#" else " ") * 16 + r[-1]
            for r in art[:-1]]
    rows += ["#" + " " * 31 + "#"] * 16 + ["#" * 33]
    return rows


def test_board_past_the_kernels_limit_is_refused(monkeypatch):
    monkeypatch.setattr(firemaker_env, "GAME_ART", GAME_ART + [_big_art()])
    tf = TF(TEnv(level=1))
    assert tf.HW == 33 * 33
    with pytest.raises(ValueError, match="1024"):
        _check_geometry(tf, 128)
    # The plain version runs it.
    S = tf.rollout(tf.init_packed(0, 4, "cpu"), 3)
    assert S["t"].min() == 6
