"""Fused rollout kernels: hand-written CUDA for the card, plain PyTorch for
CPU tensors.

Port of ``ai_safety_gridworlds_tpu/ops/__init__.py``. Only the
``firemaker_ex_ma`` kernel is ported so far.
"""


def make_fused(env):
    """The fused rollout driver for an env instance.

    Raises ``NotImplementedError`` for envs whose kernel is not ported yet
    (the port has no generic fallback path), and for configurations the
    kernel does not support."""
    name = getattr(env, "name", None)
    if name == "firemaker_ex_ma":
        from ai_safety_gridworlds_torch.ops.fused_firemaker import (
            FusedFiremaker,
        )

        return FusedFiremaker(env)
    raise NotImplementedError(
        f"the fused kernel for {name!r} is not ported yet, see ROADMAP.md"
    )
