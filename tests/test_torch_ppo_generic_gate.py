"""The port's generic-PPO learning gate on island_navigation, on the CPU.

Mirrors ``tests/test_ppo_learning.py::
test_generic_ppo_learns_island_navigation`` with the port's learner: 40
updates at B = 64, ``n_steps=32``, ``hidden=64``, ``lr=7e-4`` from
``PRNGKey(0)`` must lift the sampled policy's mean episode return by more
than 20, to above 10, with more than 50 episodes evaluated before and
after. The keys are JAX's, so the run starts from JAX's params and
episodes; float sums in another order and bfloat16 roundings that land the
other way let it drift from JAX's run, which the gate's margins absorb.
``chip_smoke.py`` runs the same gate on the card (phase 47).
"""

import pytest
import torch

from ai_safety_gridworlds_torch.core import base, threefry
from ai_safety_gridworlds_torch.envs.island_navigation import (
    IslandNavigation,
)
from ai_safety_gridworlds_torch.learners import actor_critic, ppo


def evaluate(env, params, n_steps=64, batch=64, seed=5, device="cpu"):
    """The sampled policy's mean return over the episodes that end within
    ``n_steps`` on ``batch`` fresh lanes, and their count (the JAX gate's
    ``evaluate``, key for key)."""
    eps = base.episode_reset(env, threefry.split(
        threefry.PRNGKey(seed, device), batch))
    step_keys = threefry.split(threefry.PRNGKey(seed + 1, device), n_steps)
    acc = torch.zeros(batch, device=device)
    total = torch.zeros((), device=device)
    n = torch.zeros((), device=device)
    with torch.no_grad():
        for t in range(n_steps):
            logits, _ = actor_critic.forward(params, ppo._obs(env,
                                                              eps.env_state))
            actions = threefry.categorical(step_keys[t], logits)
            eps, outs = base.episode_step(env, eps, actions + env.action_min)
            done = outs.step.game_over.to(torch.float32)
            acc = acc + outs.step.reward
            total = total + (acc * done).sum()
            n = n + done.sum()
            acc = acc * (1.0 - done)
    return float(total / torch.clamp(n, min=1.0)), int(n)


@pytest.fixture
def one_thread():
    """One intra-op thread: the B = 64 ops are too small to split, and on
    a loaded host a thread pool's workers only wait for each other (the
    gate took 4x as long with 8 threads next to 7 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_generic_ppo_learns_island_navigation(one_thread):
    env = IslandNavigation()
    config = ppo.PPOConfig(n_steps=32, hidden=64, lr=7e-4)
    state = ppo.init_train_state(env, 0, 64, config, device="cpu")
    train = ppo.make_train_step(env, config, device="cpu")
    r0, n0 = evaluate(env, state.params)
    for _ in range(40):
        state, metrics = train(state)
    assert torch.isfinite(metrics["mean_reward"])
    r1, n1 = evaluate(env, state.params)
    print(f"generic PPO gate on the CPU: r0 {r0}, r1 {r1}, episodes "
          f"{n0} -> {n1}")
    assert n0 > 50 and n1 > 50
    assert r1 - r0 > 20.0, (r0, r1)
    assert r1 > 10.0, r1
