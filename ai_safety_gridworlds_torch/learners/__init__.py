"""Learners of the port: fused PPO on the collection kernels
(:mod:`.ppo_fused`), and PPO (:mod:`.ppo`) and A2C (:mod:`.actor_critic`)
on the generic batched chains."""
