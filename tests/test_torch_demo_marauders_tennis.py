"""extraterrestrial_marauders and tennis, the port against the JAX package
on the CPU (the harness of ``tests/torch_demo_harness.py``).

Each game: ``episode_reset`` + 30 ``episode_step``s with ``observe`` at
B = 32, ``rollout(collect=True)`` at B = 32 against
``jax.jit(core.base.rollout)`` from one key, and steps from a mid-episode
JAX state carried into the port (a marauders board with one column left, a
tennis ball at a paddle). Everything exact on every lane; marauders' lanes
whose ``choice(p=)`` draw came within 4 ulps of a running sum are counted
and reported. Tennis's croppers run on the boards the steps and the
rollout made.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core import base as jbase
from ai_safety_gridworlds_torch.core import base as tbase
from ai_safety_gridworlds_torch.envs import extraterrestrial_marauders as tm
from ai_safety_gridworlds_torch.envs import tennis as tt
from torch_demo_harness import (
    check_carried,
    check_reset_and_step,
    check_rollout,
    crop_views,
    games,
)
from torch_threads import one_torch_thread  # noqa: F401

MARAUDERS = ("extraterrestrial_marauders", "ExtraterrestrialMarauders")
TENNIS = ("tennis", "Tennis")


def _keys(seed, n):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


def _report(record_property, label, near):
    record_property(f"{label}_near_lanes", near)
    print(f"{label}: {near} lanes drew within 4 ulps of a running sum "
          "(none exempt)")


# ------------------------------------------------------------------ marauders


def test_marauders_reset_and_step(record_property):
    jenv, tenv = games(*MARAUDERS, max_iterations=12)
    _report(record_property, "marauders steps",
            check_reset_and_step(jenv, tenv))


@pytest.mark.parametrize("seed", [3, 8])
def test_marauders_rollout(seed, record_property):
    jenv, tenv = games(*MARAUDERS, max_iterations=20)
    near, teps = check_rollout(jenv, tenv, seed=seed)
    _report(record_property, f"marauders rollout {seed}", near)
    assert int(teps.env_state.t.max()) < 20


def _marauders_state(jenv, seed, batch, keep_col=True):
    """JAX initial states with the formation cut to one column a lane (or
    to nothing), bolts in the air."""
    st = jax.vmap(jenv.initial_state)(_keys(seed, batch))
    m = np.asarray(st.marauders).copy()
    rng = np.random.default_rng(seed)
    for b in range(batch):
        cols = np.flatnonzero(m[b].any(axis=0))
        keep = np.zeros(m.shape[2], bool)
        if keep_col:
            keep[rng.choice(cols)] = True
        m[b] &= keep[None, :]
    up = np.full((batch, tm.N_UP_BOLTS, 2), -1, np.int32)
    up[:, 0, 0] = rng.integers(6, 14, batch)
    up[:, 0, 1] = rng.integers(0, jenv.w, batch)
    return st.replace(marauders=jnp.asarray(m), up_bolts=jnp.asarray(up))


def test_marauders_carried_one_column(record_property):
    jenv, tenv = games(*MARAUDERS, max_iterations=60)
    st = _marauders_state(jenv, 4, 32)
    assert (np.asarray(st.marauders).any(axis=1).sum(axis=1) == 1).all()
    _report(record_property, "marauders one column",
            check_carried(jenv, tenv, tm.MaraudersState, st, n_steps=25))


def test_marauders_empty_board_draws_column_zero():
    """No marauder left: all-zero weights draw column 0 on both sides (and
    no bolt fires: the formation is wiped)."""
    jenv, tenv = games(*MARAUDERS)
    st = _marauders_state(jenv, 6, 8, keep_col=False)
    from ai_safety_gridworlds_torch.ops import interop
    ts = interop.env_state_from_numpy(tm.MaraudersState, st, "cpu")
    tenv.shoot_gaps = []
    jst, jout = jax.vmap(jenv.step)(st, jnp.full((8,), 3, jnp.int32))
    tst, tout = tenv.step(ts, torch.full((8,), 3, dtype=torch.int32))
    assert np.isinf(tenv.shoot_gaps[-1].numpy()).all()
    for f in dataclasses.fields(tst):
        want = np.asarray(getattr(jst, f.name))
        got = getattr(tst, f.name).numpy()
        assert np.array_equal(want.astype(got.dtype), got), f.name
    assert np.array_equal(np.asarray(jout.step_type), tout.step_type.numpy())
    # The draw itself: index 0 from all-zero weights.
    from ai_safety_gridworlds_torch.core import threefry
    keys = _keys(1, 8)
    col = threefry.choice(torch.from_numpy(keys.astype(np.int64)), tenv.w,
                          p=torch.zeros(8, tenv.w))
    want = jax.vmap(lambda k: jax.random.choice(
        k, tenv.w, p=jnp.zeros(tenv.w)))(keys)
    assert (col.numpy() == 0).all() and np.array_equal(np.asarray(want),
                                                       col.numpy())


def test_marauders_shooter_col_hook():
    """``options['shooter_col']`` replaces the draw on both sides."""
    jenv, tenv = games(*MARAUDERS)
    keys = _keys(2, 6)
    cols = np.array([4, 5, 8, 9, 12, 30], np.int32)
    jst = jax.vmap(lambda k, c: jenv.initial_state(
        k, {"shooter_col": c}))(keys, cols)
    tst = tenv.initial_state(torch.from_numpy(keys.astype(np.int64)),
                             {"shooter_col": torch.from_numpy(cols)})
    assert np.array_equal(np.asarray(jst.down_bolts),
                          tst.down_bolts.numpy())
    a = np.full(6, 2, np.int32)
    jst2, _ = jax.vmap(lambda s, x, c: jenv.step(s, x, {"shooter_col": c}))(
        jst, a, cols[::-1].copy())
    tst2, _ = tenv.step(tst, torch.from_numpy(a),
                        {"shooter_col": torch.from_numpy(cols[::-1].copy())})
    for f in ("down_bolts", "up_bolts", "marauders", "key"):
        assert np.array_equal(np.asarray(getattr(jst2, f)).astype(np.int64),
                              getattr(tst2, f).numpy().astype(np.int64)), f


# --------------------------------------------------------------------- tennis


def test_tennis_reset_and_step():
    jenv, tenv = games(*TENNIS, max_iterations=15)
    boards = []
    check_reset_and_step(jenv, tenv, boards=boards)
    # The three croppers on lane 0's and lane 5's boards, step by step.
    for lane in (0, 5):
        lane_boards = [b[lane] for b in boards]
        crop_views(jenv.make_croppers(), tenv.make_croppers(),
                   [np.asarray(b) for b in lane_boards], lane_boards)


def test_tennis_rollout():
    jenv, tenv = games(*TENNIS, max_iterations=12)
    _, teps = check_rollout(jenv, tenv)
    # The croppers over the final boards of the lanes, lane after lane.
    tboards = list(tenv.board(teps.env_state))
    crop_views(jenv.make_croppers(), tenv.make_croppers(),
               [np.asarray(b) for b in tboards], tboards)


def test_tennis_carried_ball_at_paddle():
    """Each lane's ball one column from a paddle's hit cell, moving at it."""
    jenv, tenv = games(*TENNIS, max_iterations=40)
    batch = 32
    st = jax.vmap(jenv.initial_state)(_keys(9, batch))
    rng = np.random.default_rng(9)
    cols = np.asarray(jenv._paddle_cols)
    tops = rng.integers(1, 8, (batch, 2)).astype(np.int32)
    left = np.arange(batch) % 2 == 0
    k = np.where(left, 0, 1)
    row = tops[np.arange(batch), k] + rng.integers(0, 2, batch)
    col = np.where(left, cols[0] + 2, cols[1] - 2)
    st = st.replace(
        ball=jnp.asarray(np.stack([row, col], 1).astype(np.int32)),
        dx=jnp.asarray(np.where(left, -1, 1).astype(np.int32)),
        dy=jnp.asarray(rng.choice([-1, 0, 1], batch).astype(np.int32)),
        modulus=jnp.asarray(rng.integers(1, 6, batch).astype(np.int32)),
        paddle_tops=jnp.asarray(tops),
        t=jnp.asarray(rng.integers(0, 4, batch).astype(np.int32)),
        blink_col=jnp.asarray(col.astype(np.int32)),
    )
    check_carried(jenv, tenv, tt.TennisState, st)


def test_tennis_per_paddle_actions():
    """``[B, 2]`` actions (one a paddle) against JAX's ``[2]`` a lane."""
    jenv, tenv = games(*TENNIS)
    keys = _keys(4, 16)
    jst = jax.vmap(jenv.initial_state)(keys)
    tst = tenv.initial_state(torch.from_numpy(keys.astype(np.int64)))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(4)
    for s in range(25):
        a = rng.integers(0, 3, (16, 2)).astype(np.int32)
        jst, jout = jstep(jst, a)
        tst, tout = tenv.step(tst, torch.from_numpy(a))
        for f in dataclasses.fields(tst):
            want = np.asarray(getattr(jst, f.name)).astype(np.int64)
            got = getattr(tst, f.name).numpy().astype(np.int64)
            assert np.array_equal(want, got), (s, f.name)
        assert np.array_equal(np.asarray(jout.reward), tout.reward.numpy())
        assert tout.reward.shape == (16, 2)


def test_tennis_zero_reward_is_two_wide():
    _, tenv = games(*TENNIS)
    z = tenv.zero_reward(3, "cpu")
    assert z.shape == (3, 2) and z.dtype == torch.float32
    eps = tbase.episode_reset(tenv, torch.zeros((3, 2), dtype=torch.int64))
    assert eps.episode_return.shape == (3, 2)
    assert jbase.episode_reset(games(*TENNIS)[0], jax.random.PRNGKey(0)
                               ).episode_return.shape == (2,)
