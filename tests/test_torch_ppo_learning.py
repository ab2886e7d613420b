"""The port's fused-PPO learning gate on firemaker_ex_ma, on the CPU.

Mirrors ``tests/test_ppo_learning.py::test_fused_ppo_learns_firemaker``
with the port's learner and the plain PyTorch collection: 200 CPU-sized
updates must lift the mean evaluated episode return by more than 40 to a
positive value, with more than 100 episodes evaluated before and after.
``chip_smoke.py`` runs the same gate, with the same seeds, through the
collection kernel on the card. The port's parameter draws come from a
``torch.Generator``, not ``jax.random``, so the returns differ from the JAX
test's. The run is deterministic for a given CPU thread count (the
learner's float sums follow it); the gate's margins do not depend on it.
"""

import torch

from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_torch.learners import ppo_fused
from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker


def test_fused_ppo_learns_firemaker():
    fused = FusedFiremaker(FiremakerExMa(max_iterations=50))
    config = ppo_fused.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = ppo_fused.init_train_state(fused, 64, seed=3, config=config,
                                       device="cpu")
    train = ppo_fused.make_train_step(fused, config, device="cpu")
    ev0 = ppo_fused.evaluate(fused, state.params, n_steps=128, batch=64,
                             seed=9, device="cpu")
    for _ in range(200):
        state, metrics = train(state)
    assert torch.isfinite(metrics["mean_reward"])
    ev1 = ppo_fused.evaluate(fused, state.params, n_steps=128, batch=64,
                             seed=9, device="cpu")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    print(f"firemaker gate on the CPU: r0 {r0}, r1 {r1}")
    assert ev0["episodes"] > 100 and ev1["episodes"] > 100
    assert r1 - r0 > 40.0, (r0, r1)
    assert r1 > 0.0, r1
