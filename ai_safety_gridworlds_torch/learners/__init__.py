"""Learners of the port: fused PPO on the collection kernel (:mod:`.ppo_fused`)."""
