#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order but for 49-52, which run while phase 2 builds (they launch
no kernel of the port); any failure exits non-zero before the last line:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build the port's CUDA kernels from this checkout (``nvcc``, ``sm_90a``)
   on a thread, while phases 49-52 run; the kernel phases start once it
   has ended;
3. K2 ``prf_words`` against the plain PyTorch PRF, bit for bit, over a
   random grid of 2**20 + 8 words (uint32 edge values included);
4. K1 ``fused_firemaker_rollout`` against the plain PyTorch rollout on the
   card, every state field exactly equal, from ``init_packed(seed, 4096)``:
   the default config for 600 steps (``max_iterations=1000`` truncates at
   step 500, so the run crosses an auto-reset) and
   ``action_direction_mode=1, max_iterations=40`` for 100 steps; the
   default config for 200 steps from a seeded mid-episode state (burning
   board, busy counters, draw counters across the uint32 wrap); at a ragged
   batch (4096 + 3, no multiple of the lanes per block) for 600 steps; and
   with one and three agents (``ONE_AGENT``, ``amount_agents=3``;
   ``max_iterations=100``) for 300 steps each, so that every agent count
   the kernel instantiates runs;
5. the main path: ``BatchedEnv("firemaker_ex_ma", batch_size=4096,
   device="cuda").rollout(256)`` three times with the launch counters set
   to 0 just before and read just after; then env-steps/s, the plain
   version's time at the same shape (64 steps timed, scaled to 256), and
   K1's time by lane count (4096,
   16384, 65536) and threads per block (32, 64, 128, 256: 1, 2, 4 and 8
   lanes, one warp per lane);
6. K1's linear-policy branch (``set_policies``, the policy-search path)
   against the plain rollout, exactly, over 200 steps from
   ``init_packed(0, 4096)`` with numpy-seeded per-lane W, b and eps = 0.1;
   then again after ``set_policies`` with new values (the parameter block
   must not go stale);
7. K3 ``fused_firemaker_collect`` against the plain collection at
   B = 4096, T = 64, H = 64 with numpy-seeded MLP params: (a) teacher-forced,
   one K3 step from each plain state -- state and feats/action/reward/done
   equal except on lanes where a site-0 uniform lies within 1e-6 of a
   cumulative softmax sum (at most 0.01% of lane-steps), logp, value and boot
   within 1e-5; (b) free-running 64 steps from ``init_packed`` and from
   ``interop.busy_firemaker_state``, at most 0.1% of lanes diverged;
8. the training path: ``make_train_step(FusedFiremaker(FiremakerExMa()),
   FusedPPOConfig(n_steps=64, n_epochs=2, n_minibatches=4),
   device="cuda")`` at B = 4096, H = 64 (the configuration of ``bench.py``'s
   fused-PPO line): one warm-up step, then 3 timed steps with the launch
   counters set to 0 just before and read just after (K3 once per step);
   training env-steps/s, K3's time per call, the plain collection's time and
   the share of a step spent outside K3;
9. the learning gate of ``tests/test_ppo_learning.py::
   test_fused_ppo_learns_firemaker`` through K3: ``max_iterations=50``,
   B = 64, 200 updates, then ``evaluate`` on 128 steps over 64 lanes; more
   than 100 episodes, a return gain above 40 and a final return above 0;
10. K4 ``fused_scalar_rollout`` against the plain scalar rollout on the
   card, every state field exactly equal, from ``init_packed(seed, 4096)``:
   boat_race, island_navigation and boat_race_ex (level 2) for 300 steps
   each (two auto-resets at ``max_iterations=100``), boat_race_ex
   ``level=3, noops=False`` for 200; each env for 100 steps from
   ``interop.busy_scalar_state`` (draw counters across the uint32 wrap);
   and K4's linear branch on island_navigation over 200 steps with
   numpy-seeded per-lane W, b and eps = 0.1;
11. the scalar main path: ``BatchedEnv(name, batch_size=4096,
   device="cuda").rollout(n)`` three times for each of boat_race (n = 8192),
   island_navigation (8192) and boat_race_ex (4096), with the launch
   counters set to 0 just before and read just after (K4 once per call);
   env-steps/s, K4's time, the plain version's time at 64 steps and K4's
   time by lane count (4096, 65536, 262144);
12. K5 ``fused_scalar_collect`` against the plain collection on boat_race
   and boat_race_ex at B = 4096, T = 64, H = 64, teacher-forced and
   free-running, within phase 7's limits;
13. the scalar training path: ``make_train_step(FusedBoatRace(BoatRace()),
   FusedPPOConfig(n_steps=64, n_epochs=2, n_minibatches=4),
   device="cuda")`` at B = 4096 (``bench.py``'s scalar PPO line): one
   warm-up step, then 3 timed steps with the launch counters set to 0 just
   before and read just after (K5 once per step); training env-steps/s,
   K5's time, the share of a step outside K5 and the device's idle share;
14. the island_navigation learning gate of ``tests/test_ppo_learning.py::
   test_fused_ppo_learns_island_navigation_scalar_kernel`` through K5: B =
   64, 40 updates, then ``evaluate`` on 128 steps over 64 lanes; more than
   50 episodes, a return gain above 15 and a final return above 10;
15. K6 ``fused_island_ma_rollout`` against the plain island_navigation_ex_ma
   rollout on the card, every state field exactly equal, at B = 4096: the
   default config (level 9, two agents, ``max_iterations=100``) for 300
   steps, the rich config of ``tests/test_fused_island_ma.py`` (level 3,
   sustainability regrowth through ``expf``/``logf``, thirst death,
   oversatiation, proportional rewards) for 300,
   ``map_randomization_frequency=1, max_iterations=20`` with
   ``layout_pool=3`` for 200 steps, 100 steps from
   ``interop.busy_island_ma_state``, the default config at a ragged
   B = 4096 + 3 for 300, and K6's linear branch over 200 steps with
   numpy-seeded per-lane W, b and eps = 0.1; each at the lane group
   ``fused_island_ma._lanes_per_group`` picks and at 1, 2, 4, 8, 16 and 32
   threads a lane;
16. the island main path: ``BatchedEnv("island_navigation_ex_ma",
   batch_size=4096, device="cuda").rollout(256)`` three times with the
   launch counters set to 0 just before and read just after (K6 once per
   call); env-steps/s and the host's share of a call beside K6's time, the
   plain version's time, the bound and K6's time by lane count (4096,
   65536, 262144);
17. K7 ``fused_island_ma_collect`` against the plain collection at B =
   4096, T = 64, H = 64, teacher-forced (at the picked lane group and at
   1, 2, 4, 8, 16 and 32 threads a lane) and free-running, within phase 7's
   limits;
18. the island training path: ``make_train_step(FusedIslandMa(
   IslandNavigationExMa()), FusedPPOConfig(n_steps=64, n_epochs=2,
   n_minibatches=4), device="cuda")`` at B = 4096 (``bench.py``'s
   ``ppo_island_ma_train`` line): one warm-up step, then 3 timed steps with
   the launch counters set to 0 just before and read just after (K7 once
   per step); training env-steps/s, K7's time, the share of a step outside
   K7 and the device's idle share;
19. the island_navigation_ex_ma learning gate of
   ``tests/test_ppo_learning.py::test_fused_ppo_learns_island_ma`` through
   K7: B = 64, 40 updates, then ``evaluate`` on 128 steps over 64 lanes;
   more than 50 episodes, a return gain above 30 and a final return above
   -10;
20. K8 ``fused_savanna_rollout`` against the plain aintelope_savanna
   rollout on the card, every state field exactly equal, at B = 4096: the
   default config (level 0, one agent, the per-episode redraw) with
   ``max_iterations=100`` for 300 steps, the same with
   ``sustainability_challenge=True``, FULL (level 0 with predators, water,
   gold, silver and every resource, two agents) with ``max_iterations=60``
   for 200 steps, FULL with sustainability for 100,
   ``map_randomization_frequency=1, max_iterations=20`` with
   ``layout_pool=3`` for 200, 100 steps from ``interop.busy_savanna_state``
   (FULL with sustainability), each at the lane group the batch picks and
   again at 1, 2, 4, 8, 16 and 32 threads a lane (every group size
   ``fused_savanna._lanes_per_group`` can return); FULL with sustainability
   at a ragged B = 4096 + 3 for 100 steps; and K8's linear branch on FULL
   over 200 steps with numpy-seeded per-lane W, b and eps = 0.1;
21. the savanna main path: ``BatchedEnv("aintelope_savanna",
   batch_size=4096, device="cuda").rollout(256)`` three times, then the same
   with ``sustainability_challenge=True``, with the launch counters set to 0
   just before and read just after (K8 once per call); env-steps/s and the
   host's share of a call beside K8's time, the plain version's time, the
   bound (``savanna_step_ops``) and K8's time by lane count (4096 and
   65536; ``init_packed`` draws the savanna's boards on the host, about 7 s
   at 262144 lanes);
22. K9 ``fused_savanna_collect`` against the plain collection at B = 4096,
   T = 64, H = 64 on the default config and on FULL, teacher-forced and
   free-running, within phase 7's limits;
23. the savanna training path: ``make_train_step(FusedSavanna(
   AIntelopeSavanna()), FusedPPOConfig(n_steps=64, n_epochs=2,
   n_minibatches=4), device="cuda")`` at B = 4096 (``bench.py``'s
   ``ppo_savanna_train`` line): one warm-up step, then 3 timed steps with
   the launch counters set to 0 just before and read just after (K9 once
   per step); training env-steps/s, K9's time, the share of a step outside
   K9 and the device's idle share;
24. the aintelope_savanna learning gate of ``tests/test_ppo_learning.py::
   test_fused_ppo_learns_savanna`` through K9: ``max_iterations=50``, B =
   64, 60 updates, then ``evaluate`` on 128 steps over 64 lanes; more than
   50 episodes, a return gain above 15 and a final return above -15;
25. K4 against the plain scalar rollout on the new bodies, every state field
   exactly equal, at B = 4096: island_navigation_ex's default config (level
   9, sustainability regrowth through ``expf``/``logf``) for 300 steps
   (auto-resets at ``max_iterations=100``), its full config of ``bench.py:
   348-355`` (level 3, thirst death, oversatiation, proportional rewards) for
   300, ``level=4, sustainability_challenge=False`` for 200 and 100 steps
   from ``interop.busy_scalar_state``; absent_supervisor,
   ``distributional_shift(is_testing=True)``, ``safe_interruptibility(level=0,
   interruption_probability=1.0)`` and safe_interruptibility_ex (the bodies
   with the per-episode draw at PRF site 1) for 300 steps from init and 100
   from a busy state across the uint32 wrap of the doubled draw counter; and
   K4's linear branch on island_navigation_ex over 200 steps;
26. the new scalar main paths: ``BatchedEnv(name, batch_size=4096,
   device="cuda").rollout(4096)`` three times for island_navigation_ex (default
   and full) and each body with a reset draw, with the launch counters set to
   0 just before and read just after each path (K4 once per call);
   env-steps/s and the host's share of a call beside K4's time, the bound
   (``scalar_step_ops`` and the reset draws), the plain version's time at
   64 steps, and K4's time by lane count (4096, 65536, 262144) on
   island_navigation_ex;
27. K5 against the plain collection on island_navigation_ex and
   absent_supervisor at B = 4096, T = 64, H = 64, teacher-forced and
   free-running, within phase 7's limits;
28. the island_navigation_ex training path: ``make_train_step(
   FusedIslandNavEx(IslandNavigationEx()), FusedPPOConfig(n_steps=64,
   n_epochs=2, n_minibatches=4), device="cuda")`` at B = 4096: one warm-up
   step, then 3 timed steps with the launch counters set to 0 just before
   and read just after (K5 once per step); training env-steps/s, K5's time,
   the share of a step outside K5 and the device's idle share;
29. K4 against the plain scalar rollout on the last slice's bodies, every
   state field exactly equal, at B = 4096, on the 18 configurations of
   ``tests/test_fused_scalar.py`` (side_effects_sokoban levels 0-3,
   whisky_gold, tomato_watering and tomato_crmdp with the 13-row reset and
   physics draws, conveyor_belt in its four variants, rocks_diamonds levels
   0 and 1, conveyor_belt_ex vase and sushi_goal, friend_foe drawn, friend
   and adversary with ``extra_step``): 300 steps from ``init_packed`` (two
   auto-resets at ``max_iterations=100``) and 100 from
   ``interop.busy_scalar_state`` (draw counters across the uint32 wrap,
   tomato's ``3 * draw_ctr + 2`` too); and K4's linear branch on
   side_effects_sokoban level 1 and tomato_watering over 200 steps;
30. the last slice's main paths: ``BatchedEnv(name, batch_size=4096,
   device="cuda").rollout(4096)`` three times for side_effects_sokoban
   (levels 0 and 1), whisky_gold, tomato_watering, conveyor_belt (vase and
   sushi_goal2), rocks_diamonds, friend_foe and conveyor_belt_ex, with the
   launch counters set to 0 just before and read just after each path (K4
   once per call); env-steps/s and the host's share of a call beside K4's
   time, the bound, the plain version's time at 64 steps; and K4's times
   on all 18 main paths and K5's on its three training paths against their
   readings before the step table (``K4_BEFORE_MS``, ``K5_BEFORE_MS``);
31. K5 against the plain collection on side_effects_sokoban level 1,
   tomato_watering and friend_foe at B = 4096, T = 64, H = 64,
   teacher-forced and free-running, within phase 7's limits;
32. the side_effects_sokoban training path: ``make_train_step(
   FusedSokoban(SideEffectsSokoban(level=1)), FusedPPOConfig(n_steps=64,
   n_epochs=2, n_minibatches=4), device="cuda")`` at B = 4096 through
   ``scalar_train_path``;
33. K4's lanes per warp: on each of the 18 scalar main paths at B = 4096,
   K4 with 32, 16 and 8 of each warp's threads running a lane (the rest
   return after the table load), then 32 again (the two readings give the
   run's spread), each state bit-equal to the first; the same on
   boat_race, island_navigation_ex and friend_foe at B = 8192, 16384 and
   65536, beside the count the default picks there; and K4 at a ragged
   B = 4096 + 3 with 8 lanes a warp against the plain version;
34. K8's lane groups: on the savanna main paths (default and
   sustainability, rollout(256)) at B = 4096, 16384 and 65536, K8 at the
   threads a lane ``fused_savanna._lanes_per_group`` picks there, then at
   1, 2, 4, 8, 16 and 32, then at 1 with 8 lanes a warp (the other threads
   idle), then at the pick again (the two readings give the run's spread),
   every state bit-equal to the plain version's at B = 4096 and to the
   pick's at the larger B;
35. K6's and K7's lane groups: K6 per rollout(256) on the island main
   path at B = 4096, 16384, 65536 and 262144 and K7 per collect(64),
   H = 64, at B = 4096, 16384 and 65536, at the threads a lane
   ``fused_island_ma._lanes_per_group`` picks there (first and last: the
   run's spread), and at 1, 2, 4, 8, 16 and 32 between; every K6 state
   bit-equal to the plain version's at B = 4096 and to the pick's at the
   larger B, every K7 output bit-equal to the pick's; with the cycles a
   lane-step at the largest SM clock;
36. the generic batched path (no fused kernel; plain PyTorch on the card):
   threefry's ``split``, ``fold_in``, ``randint``, ``uniform``,
   ``permutation`` and ``bernoulli`` on the card bit-equal to the same
   calls on the CPU over 2**16 numpy-seeded keys;
37. ``BatchedEnv(name, 4096, backend="generic", device="cuda").rollout(64)``
   for boat_race and island_navigation (``kernel == "generic_torch"``, no
   fused kernel launched), then the same call twice through
   ``core.base.rollout`` with BatchedEnv's keys and policy and the board
   observation rendered and summed each step, with env-steps/s; the first
   call's final episode states (keys included) and stats equal to a CPU
   run from its key, and BatchedEnv's stats to both;
38. ``BatchedEnv("firemaker_ex_ma", 1024, backend="generic",
   device="cuda").rollout(64)`` twice with env-steps/s; then a
   64-step ``ma_rollout`` at B = 1024 on the card against the CPU, exact
   except on lanes with a spread draw within 1e-6 of its cum (at most 0.1%
   of lanes);
39. the generic path's ATen ops (a dispatch counter), kernel launches,
   device events and busy time a step (``torch.profiler``) and the
   device's idle share, each as 8 steps less 4 so that the set-up
   cancels (boat_race at B = 4096, firemaker at B = 1024), and the fused
   firemaker rollout(64) at B = 1024 against the generic one;
40. the generic chains of the other 13 scalar envs (18 configurations,
   ``GENERIC_CHAINS``): ``BatchedEnv(name, 4096, backend="generic",
   device="cuda", **kw).rollout(n)`` once each (``"auto"`` for
   human-player whisky_gold, which no fused kernel takes), n = 64 for
   bench.py's rows (boat_race_ex, island_navigation_ex default and full)
   and 32 for the others, ``kernel == "generic_torch"`` and no fused
   kernel launched, with env-steps/s;
41. each of them through ``core.base.rollout`` at B = 1024 for 32 steps on
   the card and on the CPU from one key, with ``max_iterations=15`` set on
   each env, so that every lane selects the reset branch at least twice
   (the phase fails where a configuration selects none, and prints the
   resets selected): final states, keys, step types,
   episode returns and stats equal, but for island_navigation_ex's
   fractions (within 1e-5) and lanes whose regrown power came within 1e-5
   of an integer, friend_foe's policies (within 4 ulps) and its
   auto-resets from a near-tie within 1e-6, and tomato's float returns
   (within 1e-5 relative): such lanes are exempt and counted (at most 1%);
42. bench.py's three rows in phase 37's form (rollout(64) twice
   with the board rendered and summed each step) and phase 39's count a
   step (launches, fill kernels, device busy and idle share, 8 steps less
   4);
43. the generic chains of island_navigation_ex_ma and aintelope_savanna
   (``GENERIC_MA_CHAINS``: island default, savanna default and under
   sustainability, the savanna's at ``max_iterations=40`` so that each call
   ends episodes and selects resets; a call that ends none fails):
   ``BatchedEnv(name, 4096, backend="generic",
   device="cuda", **kw).rollout(64)`` twice each, ``kernel ==
   "generic_torch"`` and no fused kernel launched (K6's and K8's counters
   read 0), with env-steps/s; then ``BatchedEnv("aintelope_savanna", 4096,
   amount_food_patches=200)`` on ``"auto"``: the top-up K8's packer refuses
   takes the generic chain, one rollout(64);
44. ``ma_rollout`` at B = 1024 for 32 steps on the card and on the CPU from
   one key (``GENERIC_MA_CHECKS``: both chains, ``SAVANNA_FULL`` with and
   without sustainability; the savanna's at ``max_iterations=20``, so that
   every lane resets at least once): final states, keys, curtains, step types,
   returns and stats equal, but for the regrown floats (within 1e-5), the
   gold and silver returns (1e-5 relative, 1e-4 absolute; their sums 1e-3)
   and lanes whose regrown power came within 1e-5 of an integer, which are
   exempt and counted (at most 1%);
45. phase 39's count for both chains at B = 4096 (ATen ops, launches, fill
   kernels, device busy ms and idle share a step, 8 steps less 4), and the
   fused main path of phases 16 and 21 (``BatchedEnv(name, 4096,
   device="cuda").rollout(64)``, timed again here) over the generic one;
46. the generic PPO learner: ``ppo.make_train_step(IslandNavigation(),
   PPOConfig(n_steps=32, lr=7e-4), device="cuda")`` (the JAX example's
   configuration, hidden 128) at B = 4096: one warm-up step, then 3 timed
   steps with the launch counters set to 0 just before and read just after
   (no fused kernel), training env-steps/s, the collection's share of a
   step, and a step's launches and the device's idle share
   (``torch.profiler``); then one ``train_step`` at B = 256 from a carried
   state (one update in) on the card and on the CPU: episodes and key
   equal but on lanes whose two largest perturbed logits lie within 1e-5
   (exempt and counted, at most 1%), params within 1e-5, the Adam moments
   within 1e-4 (1e-3 on the bfloat16 path) of their largest entries, the
   metrics within 1e-4 relative (where a lane is exempt, the update on the
   CPU's own trajectory instead);
47. the learning gate of ``tests/test_ppo_learning.py::
   test_generic_ppo_learns_island_navigation`` on the card: B = 64, 40
   updates, hidden 64; more than 50 episodes, a return gain above 20 and a
   final return above 10;
48. ``actor_critic.train_step`` at B = 1024, ``n_steps=8``, hidden 256: 3
   steps on the card and on the CPU from carried params and episodes,
   phase 46's rules (params within 1e-5, losses within 1e-4 relative),
   with training env-steps/s;
49. ``SafetyEnvironment(Game(...), seed=0, device="cuda")`` for every
   ``_make_scalar`` configuration of the JAX factory (``SHELL_CONFIGS``):
   one seeded episode of up to 50 steps on the card and on the CPU, every
   timestep, ``environment_data``, return, hidden reward and performance
   equal (friend_foe's policies within 4 ulps, tomato's float rewards within
   1e-5 relative, phase 41's rules), with the shell's steps/s on the card;
50. ``SafetyEnvironmentMo(Game(...), seed=0, log_columns=<every LOG_*
   column>, device="cuda")`` for every ``_make_mo`` configuration of the
   JAX factory (``MO_SHELL_CONFIGS``: boat_race_ex levels 0-3,
   conveyor_belt_ex's four variants, safe_interruptibility_ex levels 0-2,
   island_navigation_ex levels 0-9) and ``presets.make_experiment(name,
   seed=0, ...)`` for each of the 12 experiment presets: one seeded episode
   of up to 50 steps with seeded Q values on the card, then on the CPU
   (the class statics reset and the clock ticking alike from one instant
   in each run); every timestep, ``environment_data`` (the Generator by its
   state), seed, layout seed, episode number and performance equal, and the
   CSV and arguments files byte-equal; steps/s per run and overall, and a
   step's time split into the chain (the game's step and observe, the card
   synchronised after them), the host hooks and fetches, and the
   statistics with the CSV row;
51. ``get_environment_obj(name, seed=0, log_columns=<every LOG_* column>,
   device="cuda")`` for the multi-agent shell's configurations
   (``MOMA_SHELL_CONFIGS``: firemaker_ex_ma default, without the shuffle
   and with dict actions under the relative direction modes;
   island_navigation_ex_ma levels 0-10, with sustainability, with
   oversatiation and the proportional rewards, and with the map randomized
   per episode; aintelope_savanna default, with predators and with
   sustainability) and ``aintelope_presets.make_aintelope_experiment(name,
   seed=0, ...)`` for each of the 12 aintelope presets: one seeded episode
   of up to 50 steps with seeded per-agent Q values on the card, then on
   the CPU (the class statics and randomized maps reset, the clock ticking
   alike in each run); every timestep, ``environment_data``, seed, layout
   seed, episode number and performance equal and the CSV and arguments
   files byte-equal (up to a step whose regrown island power came within
   1e-5 of an integer, phase 41's rule, counted); no fused kernel
   launches; steps/s per run, per family and overall, and a step's time
   split into the chain (the game's step, sub-step, end of step and
   observe, the card synchronised after them), the host mirrors, hooks and
   fetches, and the statistics with the CSV row;
52. the adapters over the shells, ``device="cuda"`` against the same run
   on the CPU (the class statics and randomized maps reset and numpy
   seeded before each): the 14 demonstrations of 7 envs through
   ``GridworldGymEnv``, each to its exact return, safety performance and
   termination; one seeded episode of up to 30 steps through
   ``GridworldGymEnv`` on each of the 47 names, actions sampled from the
   seeded action space, with the options spread over the names
   (``GYM_OPTION_SETS``: transitions, flattening, ASCII, multi-discrete,
   object coordinates, the layer cube; the multi-agent names driven as a
   single agent), every step and its ``ansi`` and ``rgb_array`` renders
   equal; ``GridworldZooParallelEnv`` (15 steps) and
   ``GridworldZooAecEnv`` (40 turns) on the three multi-agent
   configurations of ``tests/test_zoo_conformance.py``, two aintelope
   presets and ``test_death`` (``ZOO_CONFIGS``), equal (a run is compared
   up to a step whose regrown island power came within 1e-5 of an
   integer, phase 51's rule, counted); ``register_with_gym``,
   ``gym.make`` and gymnasium's ``check_env`` on every name, and
   PettingZoo's ``parallel_api_test`` and ``api_test``, where the host has
   the libraries (null with the reason where not); a pickle round trip of
   an adapter of each shell and adapter family, the copy stepping as the
   original; a headless ``AgentViewer``'s frames equal to the CPU's; no
   fused kernel launches; steps/s per adapter and the adapter's own host
   time a step (its step less the shell's);
53. scale-out (``parallel/mesh.py``, ``parallel/multihost.py``, the
   lane-sharded fused drivers, ``make_sharded_train_step``,
   ``param_shardings``, ``utils/checkpoint.py``, ``utils/profiling.py``),
   in rank processes this phase starts (each within SCALEOUT_TIMEOUT_S; a
   rank that fails fails the run), which load the kernels the build left:
   one rank on NCCL: the sharded firemaker rollout(256) at B = 4096 equal in
   every field to ``BatchedEnv``'s unsharded K1 run, and
   ``make_sharded_train_step`` on island_navigation_ex_ma (B = 4096,
   ``FusedPPOConfig(n_steps=64, n_epochs=2, n_minibatches=4)``, H = 64)
   equal to ``make_train_step`` in params, Adam state and ``S`` after two
   steps, both timed, with the collectives' share; two gloo ranks sharing
   the card (NCCL refuses two ranks on one device): K1, K6 and K8 (default
   and a layout pool of 3) on each rank's lanes equal to the unsharded
   launch, the two-rank PPO step on K7 (B = 4096) and on K3, K5 and K9 (B =
   256) against the same two-rank step on the CPU (phase 7's exemption and
   free-running divergence share; params within 2 * lr per update; metrics
   within LEARNER_RTOL relative plus FLOAT_TOL, the kernels' logp and value
   bound, where no lane is exempt), A2C's ``train_step`` under
   a ``(1, 2)`` mesh within one bfloat16 ulp of the largest gradient (times
   lr) of one process's step, a sharded checkpoint round trip of the
   island state with the resume bit-exact (bytes and ms of save and
   restore); then ``measure_steps_per_second`` on generic boat_race at
   B = 4096 and ``per_step_latency`` (host clock and CUDA events), and a
   ``utils.profiling.trace`` of one fused ``train_step`` each on K3, K5, K7
   and K9 with the device rows it holds;
54. K8 and K9 at 3-10 agents (the wide kernel, whose agents' rows sit in
   shared memory): K8 against the plain rollout, every state field exactly
   equal, for ceil(100 / N) + 2 steps (across an auto-reset) from
   ``init_packed(seed, 4096)`` at N = 3, 4, 5, 7 and 10 agents
   (``max_iterations=100``), at 10 on FULL with sustainability and
   at 10 on a 15 x 15 resized map (every agent on the board, a redraw each
   episode; the level's art holds two agents and parks the others at cell
   0), each at the picked lane group and at 1 and 32 threads a lane, with
   its time and bound for those steps (and on the resized map its time per
   rollout(256)); K9 against the plain collection at
   5 and 10 agents as phase 7 holds it (free-running from the busy state),
   and its time and bound per collect(64) at 3, 4, 5, 7 and 10;
   ``BatchedEnv("aintelope_savanna", 4096, device="cuda",
   amount_agents=N).rollout(256)`` at N = 5 and 10 three times with the
   launch counters at 0 just before, K8's time, env-steps/s, the host's
   share, K8's bound, and the plain version and the generic chain (the
   path ``"auto"`` took at 5-10 agents before) over a few steps, scaled;
   the training path at five agents (a warm-up and three timed
   ``train_step``s, K9 once each). The build phase prints every K8/K9
   instantiation's registers and spill bytes and fails where a wide one
   spills;
55. one JSON line of kernel results: ``kernels`` holds K1 with its launches
   on the main path (phase 5) and on the policy-search check (phase 6), K3
   with its launches on the training path (phase 8), K4 with its launches on
   the scalar main paths (phases 11, 26 and 30, by path and env), K5 with
   its launches on the scalar training paths (phases 13, 28 and 32), K6 with its launches on the island main path
   (phase 16), K7 with its launches on the island training path (phase
   18), K8 with its launches on the savanna main paths (phases 21 and 54,
   by path, with phase 54's rows by agent count in ``per_agent_count``) and
   K9 with its launches on the savanna training paths (phases 23 and 54),
   each with its largest error against its plain version, its times,
   its bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over 67 T/s, whichever is larger, counted from this run's
   inputs) and ``library_ms`` (null: no single PyTorch call computes these
   functions); ``checked_off_path`` holds K2, which no driven path launches
   (K1 and K3-K9 inline the same PRF header), with its phase-3 launches;
   ``generic`` holds phases 36-45's rates, launches, exempt lanes and
   idle shares, ``learners`` phases 46-49's, ``mo_shell`` phase 50's,
   ``moma_shell`` phase 51's, ``adapters`` phase 52's, ``scaleout`` phase
   53's; each kernel also carries ``sharded_launches``, its launches on
   phase 53's sharded paths summed over the ranks;
   then the card's name and power limit and the last line ``{"ok": true,
   "device": {...}}``.

Imports nothing of JAX. Needs one CUDA card.

    python3 chip_smoke.py --time-scalar ROOT

times K4 on its 18 main paths (at each path's shape, B = 4096) and K5
(collect(64), H = 64) on its three training paths with the port imported
from the checkout at ROOT, and prints them as one JSON line with the
nanoseconds per lane-step and the card's largest SM clock: run it on two
checkouts in one call (parent, change, change, parent) to compare them on
one card.

    python3 chip_smoke.py --time-firemaker ROOT

does the same for K1 (rollout(256)) and K3 (collect(64), H = 64) at
B = 4096 from ``init_packed(SEED, 4096)``, each at its checkout's default
tile.

    python3 chip_smoke.py --time-savanna ROOT

does the same for K8 (rollout(256): default, sustainability, FULL and FULL
with sustainability) and K9 (collect(64), H = 64: default and FULL) at
B = 4096 from ``init_packed(SEED, 4096)``, at the checkout's defaults.

    python3 chip_smoke.py --sweep-savanna

times K8 on FULL and FULL with sustainability and K9 on its default and
FULL by threads a lane, as phase 34 does for the main paths, and prints
one JSON line.

    python3 chip_smoke.py --agents

builds the savanna kernels (printing their registers and spill bytes) and
runs phase 54 alone, and prints one JSON line.

    python3 chip_smoke.py --sweep-savanna-agents

times K8 at 5 and 10 agents (default, and 10 on the resized map) and K9 at
5 and 10 by threads a lane at 4096, 16384 and 65536 lanes, and prints one
JSON line.

    python3 chip_smoke.py --time-island ROOT

times K6 (rollout(256): default, rich, layout_pool=3 and the linear
policy at B = 4096; default at B = 65536 and 262144) and K7 (collect(64),
H = 64, at B = 4096) with the port of the checkout at ROOT at its
defaults, as one JSON line with the cycles a lane-step; run parent,
change, change, parent in one call.

    python3 chip_smoke.py --sweep-island

runs phase 35's sweep of K6 and K7 by threads a lane and batch alone and
prints one JSON line.

    python3 chip_smoke.py --generic

runs phases 36-45 (the generic path) alone, without building the kernels
(phase 39's fused comparison then builds K1), and prints one JSON line.

    python3 chip_smoke.py --learners

runs phases 46-49 (the generic learners and the scalar shell) alone,
without building the kernels, and prints one JSON line.

    python3 chip_smoke.py --shells

runs phases 49-51 (the scalar, the MO and the multi-agent shells) alone,
without building the kernels, and prints one JSON line.

    python3 chip_smoke.py --adapters

runs phase 52 (the Gym and PettingZoo adapters) alone, without building
the kernels, and prints one JSON line.

    python3 chip_smoke.py --scaleout

builds the kernels and runs phase 53 (scale-out) alone, and prints one
JSON line; its rank processes run ``chip_smoke.py --scaleout-rank MODE
WORLD RANK STORE DIR``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

BATCH = 4096
MAIN_STEPS = 256
MAIN_CALLS = 3
SEED = 0
SWEEP_BATCHES = (BATCH, 4 * BATCH, 16 * BATCH)
# K1/K3's threads per block (one warp per lane: tile // 32 lanes).
TILES = (32, 64, 128, 256)
# One agent: firemaker without a supervisor, with the supervisor rewards
# moved onto a dim the workers' reward space enables (the defaults name
# dims only the supervisor's enables, and the fused class refuses them).
ONE_AGENT = {"amount_agents": 1, **{
    k: '{"ENERGY": -1}' for k in ("SUPERVISOR_TRESPASSING_REWARD",
                                  "SUPERVISOR_STOP_BUTTON_REWARD",
                                  "SUPERVISOR_WORKSHOP_REWARD")}}
# (label, env kwargs, steps, start, batch): "init" is init_packed(SEED,
# batch), "busy" is interop.busy_firemaker_state(fused, SEED, batch).
K1_CHECKS = (
    ("default", {}, 600, "init", BATCH),
    ("adm1_maxit40", {"action_direction_mode": 1, "max_iterations": 40}, 100,
     "init", BATCH),
    ("default_busy", {}, 200, "busy", BATCH),
    ("default_ragged", {}, 600, "init", BATCH + 3),
    ("one_agent", dict(ONE_AGENT, max_iterations=100), 300, "init", BATCH),
    ("three_agents", {"amount_agents": 3, "max_iterations": 100}, 300, "init",
     BATCH),
)
K1_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:432 (_rollout_pallas_call) "
    "x ai_safety_gridworlds_tpu/ops/fused_firemaker.py:373 (_step)"
)
K2_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/prng.py:44 (hash_u32), :63 (uniform01)"
)
K3_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:635 (_rollout_collect_pallas, "
    "pallas_call :718) x :594 (_collect_step) x :196 (_mlp_policy_actions) x "
    ":171 (_mlp_forward_agent) x :582 (_bootstrap_value) x "
    "ai_safety_gridworlds_tpu/ops/fused_firemaker.py:373 (_step), :310 "
    "(_policy_feats)"
)
K4_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:432 (_rollout_pallas_call) "
    "x ai_safety_gridworlds_tpu/ops/fused_scalar.py:166 "
    "(FusedScalarBase._step, _move :132, _read :149, the reset draw "
    ":177-191), :368 (FusedBoatRace._physics), :454 (FusedIslandNav._physics), "
    ":571 (FusedBoatRaceEx._physics), :770 (FusedIslandNavEx._physics), "
    ":1198/:1205 (FusedAbsentSupervisor._reset_extras/_physics), :1285/:1297 "
    "(FusedDistributionalShift), :1385/:1394 (FusedSafeInterruptibility), "
    ":2236 (FusedSafeInterruptibilityEx._physics), :1054 (FusedSokoban), "
    ":1477 (FusedWhiskyGold), :1577/:1586 (FusedTomatoWatering), :1669 "
    "(FusedConveyorBelt), :1828 (FusedRocksDiamonds), :1998/:2028 "
    "(FusedFriendFoe), :2135 (FusedConveyorBeltEx)"
)
K5_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:635 (_rollout_collect_pallas, "
    "pallas_call :718) x :594 (_collect_step) x :196 (_mlp_policy_actions) x "
    ":582 (_bootstrap_value) x ai_safety_gridworlds_tpu/ops/fused_scalar.py:166 "
    "(FusedScalarBase._step) with the :368, :454, :571, :770, :1198/:1205, "
    ":1285/:1297, :1385/:1394, :2236, :1054, :1477, :1577/:1586, :1669, "
    ":1828, :1998/:2028 and :2135 bodies"
)
# K1's and K3's times at the main-path shapes in the earlier design, one
# thread per lane (PERF.md; NVIDIA H100 80GB HBM3 at 700 W).
K1_BEFORE_MS = 123.934
K3_BEFORE_MS = 34.213
# (name, env kwargs, rollout steps of the scalar main path).
SCALAR_MAIN = (
    ("boat_race", {}, 8192),
    ("island_navigation", {}, 8192),
    ("boat_race_ex", {}, 4096),
)
# (label, name, env kwargs, steps, start) of the K4 checks.
K4_CHECKS = (
    ("boat_race", "boat_race", {}, 300, "init"),
    ("island_navigation", "island_navigation", {}, 300, "init"),
    ("boat_race_ex", "boat_race_ex", {}, 300, "init"),
    ("boat_race_ex_l3", "boat_race_ex", {"level": 3, "noops": False}, 200,
     "init"),
    ("boat_race_busy", "boat_race", {}, 100, "busy"),
    ("island_navigation_busy", "island_navigation", {}, 100, "busy"),
    ("boat_race_ex_busy", "boat_race_ex", {}, 100, "busy"),
)
SCALAR_SWEEP = (BATCH, 16 * BATCH, 64 * BATCH)
# island_navigation_ex's full configuration (bench.py:348-355).
INX_FULL = dict(level=3, sustainability_challenge=True,
                thirst_hunger_death=True, penalise_oversatiation=True,
                use_satiation_proportional_reward=True)
# The bodies with a per-episode draw, in the configurations the K4 checks
# and main paths use.
RESET_BODIES = (
    ("absent_supervisor", {}),
    ("distributional_shift", {"is_testing": True}),
    ("safe_interruptibility", {"level": 0, "interruption_probability": 1.0}),
    ("safe_interruptibility_ex", {}),
)
# (label, name, env kwargs, steps, start) of phase 25's K4 checks.
K4_NEW_CHECKS = (
    ("island_navigation_ex", "island_navigation_ex", {}, 300, "init"),
    ("island_navigation_ex_full", "island_navigation_ex", INX_FULL, 300,
     "init"),
    ("island_navigation_ex_l4", "island_navigation_ex",
     {"level": 4, "sustainability_challenge": False}, 200, "init"),
    ("island_navigation_ex_busy", "island_navigation_ex", {}, 100, "busy"),
) + tuple(
    (name + suffix, name, kw, steps, start)
    for name, kw in RESET_BODIES
    for suffix, steps, start in (("", 300, "init"), ("_busy", 100, "busy"))
)
# (label, name, env kwargs) of phase 26's main paths, rollout(4096) each.
SCALAR_NEW_MAIN = (
    ("island_navigation_ex", "island_navigation_ex", {}),
    ("island_navigation_ex_full", "island_navigation_ex", INX_FULL),
) + tuple((name, name, kw) for name, kw in RESET_BODIES)
SCALAR_NEW_STEPS = 4096
# The last slice's bodies: (label, name, env kwargs) of the 18
# configurations of tests/test_fused_scalar.py.
LAST_BODIES = (
    ("sokoban_l0", "side_effects_sokoban", {}),
    ("sokoban_l1_noops", "side_effects_sokoban", {"level": 1, "noops": True}),
    ("sokoban_l2", "side_effects_sokoban", {"level": 2}),
    ("sokoban_l3", "side_effects_sokoban", {"level": 3}),
    ("whisky_gold", "whisky_gold", {}),
    ("tomato_watering", "tomato_watering", {}),
    ("tomato_crmdp", "tomato_crmdp", {}),
    ("conveyor_vase", "conveyor_belt", {"variant": "vase"}),
    ("conveyor_sushi", "conveyor_belt", {"variant": "sushi"}),
    ("conveyor_sushi_goal", "conveyor_belt",
     {"variant": "sushi_goal", "noops": True}),
    ("conveyor_sushi_goal2", "conveyor_belt", {"variant": "sushi_goal2"}),
    ("rocks_l0", "rocks_diamonds", {}),
    ("rocks_l1", "rocks_diamonds", {"level": 1}),
    ("conveyor_ex_vase", "conveyor_belt_ex", {"variant": "vase"}),
    ("conveyor_ex_sushi_goal", "conveyor_belt_ex",
     {"variant": "sushi_goal", "noops": True}),
    ("friend_foe", "friend_foe", {}),
    ("friend_foe_friend", "friend_foe", {"bandit_type": "friend"}),
    ("friend_foe_adversary_extra", "friend_foe",
     {"bandit_type": "adversary", "extra_step": True}),
)
# (label, name, env kwargs) of phase 30's main paths, rollout(4096) each.
LAST_MAIN = (
    ("side_effects_sokoban", "side_effects_sokoban", {}),
    ("side_effects_sokoban_l1", "side_effects_sokoban", {"level": 1}),
    ("whisky_gold", "whisky_gold", {}),
    ("tomato_watering", "tomato_watering", {}),
    ("conveyor_belt_vase", "conveyor_belt", {"variant": "vase"}),
    ("conveyor_belt_sushi_goal2", "conveyor_belt", {"variant": "sushi_goal2"}),
    ("rocks_diamonds", "rocks_diamonds", {}),
    ("friend_foe", "friend_foe", {}),
    ("conveyor_belt_ex", "conveyor_belt_ex", {}),
)
# K5's training paths: (name, env kwargs).
K5_TRAIN_PATHS = (
    ("boat_race", {}),
    ("island_navigation_ex", {}),
    ("side_effects_sokoban", {"level": 1}),
)
# K4's and K5's times before the step table (PERF.md's table; NVIDIA H100
# 80GB HBM3 at 700 W): ms per rollout(n) at B = 4096 on each main path, and
# per collect(64), H = 64, on the three training paths.
K4_BEFORE_MS = {
    "boat_race": 3.861, "island_navigation": 1.924, "boat_race_ex": 3.353,
    "island_navigation_ex": 6.761, "island_navigation_ex_full": 7.169,
    "absent_supervisor": 1.196, "distributional_shift": 1.288,
    "safe_interruptibility": 1.133, "safe_interruptibility_ex": 1.149,
    "side_effects_sokoban": 4.906, "side_effects_sokoban_l1": 2.672,
    "whisky_gold": 1.049, "tomato_watering": 2.207,
    "conveyor_belt_vase": 1.797, "conveyor_belt_sushi_goal2": 2.034,
    "rocks_diamonds": 2.191, "friend_foe": 2.354, "conveyor_belt_ex": 2.076,
}
K5_BEFORE_MS = {"boat_race": 0.976, "island_navigation_ex": 0.939,
                "side_effects_sokoban": 1.216}
# Threads of each warp that run a lane in K4's sweep (phase 33), and the
# paths and larger batches it also times them on.
LANES_PER_WARP = (32, 16, 8)
LANE_SWEEP_PATHS = ("boat_race", "island_navigation_ex", "friend_foe")
LANE_SWEEP_BATCHES = (2 * BATCH, 4 * BATCH, 16 * BATCH)
K6_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:432 (_rollout_pallas_call, "
    "pallas_call :491) x ai_safety_gridworlds_tpu/ops/fused_island_ma.py:376 "
    "(FusedIslandMa._step), :357 (_policy_feats) x "
    "ai_safety_gridworlds_tpu/ops/fused_base.py:360 (_pool_select)"
)
K7_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:635 (_rollout_collect_pallas, "
    "pallas_call :718) x :594 (_collect_step) x :582 (_bootstrap_value) x "
    "ai_safety_gridworlds_tpu/ops/fused_island_ma.py:376 (FusedIslandMa._step) "
    "x ai_safety_gridworlds_tpu/ops/fused_base.py:360 (_pool_select)"
)
# tests/test_fused_island_ma.py's rich configuration.
ISLAND_RICH = dict(level=3, sustainability_challenge=True,
                   thirst_hunger_death=True, penalise_oversatiation=True,
                   use_satiation_proportional_reward=True)
# (label, env kwargs, layout pool, steps, start, batch) of the K6 checks;
# "busy" is interop.busy_island_ma_state(fused, SEED, BATCH).
K6_CHECKS = (
    ("default", {}, 1, 300, "init", BATCH),
    ("rich", ISLAND_RICH, 1, 300, "init", BATCH),
    ("pool3", {"map_randomization_frequency": 1, "max_iterations": 20}, 3, 200,
     "init", BATCH),
    ("busy", {}, 1, 100, "busy", BATCH),
)
ISLAND_SWEEP = (BATCH, 16 * BATCH, 64 * BATCH)
# K6/K7's lane groups (threads per lane): phases 15 and 17 check them at each
# of these, every size fused_island_ma._lanes_per_group can return.
ISLAND_GROUPS = (1, 2, 4, 8, 16, 32)
# Phase 35 and --sweep-island: the batches of K6's and K7's g x B sweeps.
ISLAND_GROUP_BATCHES = (BATCH, 4 * BATCH, 16 * BATCH, 64 * BATCH)
ISLAND_COLLECT_BATCHES = (BATCH, 4 * BATCH, 16 * BATCH)
K8_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:432 (_rollout_pallas_call, "
    "pallas_call :491) x ai_safety_gridworlds_tpu/ops/fused_savanna.py:702 "
    "(FusedSavanna._step), :630 (_redraw_layout), :86 (_lut_select), :611 "
    "(_policy_feats) x ai_safety_gridworlds_tpu/ops/fused_base.py:360 "
    "(_pool_select)"
)
K9_REPLACES = (
    "ai_safety_gridworlds_tpu/ops/fused_base.py:635 (_rollout_collect_pallas, "
    "pallas_call :718) x :594 (_collect_step) x :582 (_bootstrap_value) x "
    "ai_safety_gridworlds_tpu/ops/fused_savanna.py:702 (FusedSavanna._step), "
    ":630 (_redraw_layout)"
)
# Level 0 with every savanna feature its art holds.
SAVANNA_FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
SAVANNA_SUSTAIN = {"sustainability_challenge": True}
# (label, env kwargs, layout pool, steps, start) of the K8 checks; "busy" is
# interop.busy_savanna_state(fused, SEED, BATCH).
K8_CHECKS = (
    ("default", {"max_iterations": 100}, 1, 300, "init"),
    ("sustain", dict(SAVANNA_SUSTAIN, max_iterations=100), 1, 300, "init"),
    ("full", dict(SAVANNA_FULL, max_iterations=60), 1, 200, "init"),
    ("full_sustain", dict(SAVANNA_FULL, **SAVANNA_SUSTAIN), 1, 100, "init"),
    ("pool3", {"map_randomization_frequency": 1, "max_iterations": 20}, 3, 200,
     "init"),
    ("busy", dict(SAVANNA_FULL, **SAVANNA_SUSTAIN), 1, 100, "busy"),
)
SAVANNA_SWEEP = (BATCH, 16 * BATCH)
# K8/K9's lane groups (threads per lane): phase 20 checks K8 at each of them,
# a superset of what fused_savanna._lanes_per_group can return.
SAVANNA_GROUPS = (1, 2, 4, 8, 16, 32)
# Phase 34 and --sweep-savanna: (threads per lane, lane groups per warp or
# None for 32 // g) at GROUP_SWEEP_BATCHES.
GROUP_SWEEP = ((1, None), (2, None), (4, None), (8, None), (16, None),
               (32, None), (1, 8))
GROUP_SWEEP_BATCHES = (BATCH, 4 * BATCH, 16 * BATCH)
# --time-savanna's K8 and K9 configurations.
SAVANNA_TIMED = (("default", {}), ("sustain", SAVANNA_SUSTAIN),
                 ("full", SAVANNA_FULL),
                 ("full_sustain", dict(SAVANNA_FULL, **SAVANNA_SUSTAIN)))
SAVANNA_GATE_UPDATES = 60
SCALAR_PLAIN_STEPS = 64
# The plain versions' timed rollouts on the MA main paths (phases 5, 16 and
# 21) run this many steps; their times are scaled to MAIN_STEPS.
PLAIN_TIMED_STEPS = 64
GATE_UPDATES = 40
POLICY_STEPS = 200
COLLECT_STEPS = 64
HIDDEN = 64
TRAIN_CALLS = 3
CDF_GAP = 1e-6
MAX_EXEMPT_SHARE = 1e-4    # of teacher-forced lane-steps
MAX_DIVERGED_SHARE = 1e-3  # of lanes after a free-running collection
FLOAT_TOL = 1e-5           # logp, value and boot against the plain version

# Bounds: the larger of the bytes a call must move over the H100's memory
# rate and its operations over the peak rate of scalar float32 operations
# outside the tensor cores (67 TFLOP/s, also taken for the int32 hash
# arithmetic, which makes the bound a least time).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per cell and acting sub-step, counted from fused_firemaker.cu:
# the PRF hash (2 multiplies and 3 xors, two 8-operation murmur3
# finalizers), uniform01 (shift, convert, scale), the draw and the
# external-fire count.
OPS_PER_CELL = 21 + 3 + 4
# At each spreadable cell, per stencil row: the window's offset, its read,
# shift and mask, the table read and the multiply; then 1 - prod. (The
# earlier design tested each of the 24 terms: 4 operations a term and 6
# more, 102 operations a cell.)
OPS_PER_STENCIL_ROW = 6


# The process's start: each phase's header line carries the seconds since.
T_START = time.perf_counter()


def log(msg=""):
    if msg.startswith("== "):
        msg += f"  [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_use(text):
    """{kernel<N[,MODE]>: registers and spill bytes} of each entry function
    in an ``nvcc -Xptxas -v`` log. The spill line read is the one under the
    entry's own "Function properties" line, not those of the device
    functions listed after it."""
    import re

    use, name, entry, own = {}, None, None, False
    for line in text.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry, own = m.group(1), False
            t = re.match(r"_Z\d+(\w+?)ILi(\d+)E(?:Li(\d+)E)?E", entry)
            name = None if t is None else f"{t.group(1)}<{t.group(2)}" + (
                f",{t.group(3)}>" if t.group(3) else ">")
            if name is not None:
                use[name] = {"registers": None, "spill_stores": 0,
                             "spill_loads": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            own = m.group(1) == entry
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and own:
            use[name]["spill_stores"] = int(m.group(1))
            use[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and use[name]["registers"] is None:
            use[name]["registers"] = int(m.group(1))
    return use


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


def state_words(fused):
    """32-bit words per lane of the packed state."""
    return sum(fused.field_spec(k)[0] for k in fused.STATE_FIELDS)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of a call that moves ``n_bytes`` and does
    ``n_ops`` operations."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def step_ops(fused, acting_substeps):
    """Operations of the firemaker step for ``acting_substeps`` acting
    agent sub-steps (every cell hashed, the stencil at every spreadable
    cell, one table lookup per row of equal dr)."""
    n_spread = int((fused.consts["spreadable"] > 0.5).sum())
    n_rows = len(fused.spread_rows)
    return acting_substeps * (
        fused.HW * OPS_PER_CELL
        + n_spread * (n_rows * OPS_PER_STENCIL_ROW + 1)
    )


# Operations per acting lane-step of K4, counted from fused_scalar.cu: the
# action draw (PRF hash 21, uniform01 3, scale, floor, convert, add, clamp 6),
# the bounded move (row and column 3, two delta reads, two adds, the bounds
# test 7, the clamped candidate 6, the wall read and test 2, the select 1),
# and the accounting (t, truncation and game-over 5, returns, type,
# episodes and stats 8, the counter 1; 4 per reward dim).
SCALAR_SHELL_OPS = 30 + 23 + 14
SCALAR_OPS_PER_DIM = 4
# The bodies: the goal-stripe events (moved, drow and dcol 11, flags and
# class reads and tests 7, entry and exit tests 15, the sign 7) with boat
# race's reward and hidden terms (4); island's goal and water reads and
# tests, reward, hidden and safety (13); boat_race_ex's events, noop test,
# visit read, add and store and goal and human reads (50), and two operations
# per reward term and dim (at most 5 terms).
# island_navigation_ex's body: the code and distance reads (2), the
# availability reset without sustainability (4), the noop test (1), the
# satiation decrements (2), the death tests (3), the goal test (2), each
# consumption's visit, tests, satiation gain and cap and availability loss
# (2 x 10), the non-drink/food tests (2), gold, silver and gap tests and
# visits (6), the homeostasis tests (2 x 4), the water test (2), each
# regrowth's tests, sum, log, product, exp, cap, floor and fraction (2 x 11,
# a transcendental counted as one operation) and the safety convert (1):
# 75; about 4 reward terms fire per step, 2 operations per dim each.
# absent_supervisor: goal and punishment tests, the supervisor test, base,
# observed and hidden rewards (13); distributional_shift: the goal, the
# layout select, the lava test and the reward (13); safe_interruptibility:
# the button, the freeze, the select, the goal, reward and hidden (16),
# with the _ex variant's doubling (19).
# The last slice's bodies, where a push is the target (row and column 3, two
# adds, the bounds 7, the clamp 6: 18), the agent-behind test (10) and the
# blocking reads and tests: side_effects_sokoban 43 + per box the push (18 +
# 10 + wall and coin reads and tests 4 + the conditions 5 + the refund when
# it moves 4) and its occupancy compares; whisky_gold 16 (drunk, goal,
# bonus, reward, exploring); tomato_watering 13 x 31 (each tomato's
# watering compare, select and max, its PRF hash 21 and uniform01 3, the
# drying test, product and sum) + 4; conveyor_belt 90 (the push by the
# scalar deltas, the agent's blocking, removal, goal, the belt and the end
# event), conveyor_belt_ex's 4 reward terms at 2 operations a dim;
# rocks_diamonds per lump the reward (8), the push (18 + 10 + 4 + 4) and
# the occupancy and agent compares, + 11 for the switches and the agent's
# blocking; friend_foe 45 (the box cells, the markers, the choice, the
# smoothing update, the reward and the end).
SCALAR_BODY_OPS = {"boat_race": 44, "island_navigation": 13,
                   "boat_race_ex": 50, "island_navigation_ex": 75,
                   "absent_supervisor": 13, "distributional_shift": 13,
                   "safe_interruptibility": 16,
                   "safe_interruptibility_ex": 19,
                   "side_effects_sokoban": lambda f: 43 + f.nb * (41 + f.nb),
                   "whisky_gold": 16, "tomato_watering": 13 * 31 + 4,
                   "tomato_crmdp": 13 * 31 + 4, "conveyor_belt": 90,
                   "conveyor_belt_ex": 90,
                   "rocks_diamonds": lambda f: f.nl * (44 + f.nl) + 11,
                   "friend_foe": 45}
SCALAR_BODY_OPS_PER_DIM = {"boat_race_ex": 10, "island_navigation_ex": 8,
                           "conveyor_belt_ex": 8}
# The per-episode draw of a resetting lane, per row drawn: the counter (2),
# the PRF hash (21), uniform01 (3) and the drawn value (2); boat_race_ex's
# visit board is rewritten whole (5 operations a cell), side_effects_sokoban
# restores its coin-start cells only (the cell's read, its address and the
# store: 3 a coin).
SCALAR_RESET_DRAW_OPS = 28
SCALAR_RESET_OPS_PER_CELL = 5
SCALAR_RESET_OPS_PER_COIN = 3


def scalar_step_ops(fused):
    """Operations of one acting lane-step of the scalar shell and body."""
    name = fused.env.name
    body = SCALAR_BODY_OPS[name]
    return (SCALAR_SHELL_OPS + (body(fused) if callable(body) else body)
            + fused.D * (SCALAR_OPS_PER_DIM
                         + SCALAR_BODY_OPS_PER_DIM.get(name, 0)))


def scalar_reset_ops(fused):
    """Operations of one resetting lane-step: the rows its per-episode draw
    hashes (tomato_watering only those of the tomatoes watered at the
    start) and the reset of a lane board."""
    rows = fused.RESET_ROWS * fused.RESET_SITES
    if fused.env.name in ("tomato_watering", "tomato_crmdp"):
        rows = int((fused._kstatics_np["iw"] > 0.5).sum())
    board = 0
    if fused.env.name == "side_effects_sokoban":
        board = len(fused._coin_cells()) * SCALAR_RESET_OPS_PER_COIN
    elif fused.LANE_BOARD:
        board = fused.HW * SCALAR_RESET_OPS_PER_CELL
    return rows * SCALAR_RESET_DRAW_OPS + board


def scalar_call_ops(fused, lane_steps, resets):
    """Operations of a scalar call: the body on acting lane-steps, the
    per-episode draws on resetting ones."""
    return ((lane_steps - resets) * scalar_step_ops(fused)
            + resets * scalar_reset_ops(fused))


def scalar_resets(S0, S1, torch):
    """Lane-steps between states S0 and S1 that were resets (no physics):
    each finished episode is followed by one, except for lanes still in
    LAST at the end; lanes in LAST at the start add one."""
    last0 = int((S0["step_types"] == 2).sum())
    last1 = int((S1["step_types"] == 2).sum())
    done = int((S1["stats_episodes"].to(torch.int64)
                - S0["stats_episodes"]).sum())
    return done + last0 - last1


def mlp_ops(fused, hidden):
    """Operations of one agent's MLP forward, softmax and draw in K3."""
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    return 12 + hidden * (2 * F + 1 + 2 * (A + 1)) + 6 * A


def lanes_differ(x, y, fields):
    """Bool [B]: lanes where any of ``fields`` differs."""
    import torch

    out = None
    for k in fields:
        a, b = x[k], y[k]
        if not a.is_floating_point():
            a, b = a.to(torch.int64), b.to(torch.int64)
        d = (a != b).any(dim=0)
        out = d if out is None else out | d
    return out


def rollout_equal(label, fused, Sk, Sp, torch):
    """Fail unless the kernel's state ``Sk`` equals the plain version's
    ``Sp`` in every field, both with each field's ``field_spec`` dtype and
    shape, and every float field of ``Sk`` is finite (phases 4, 6, 10, 15).
    Returns the largest float difference."""
    B = Sp["t"].shape[1]
    for k in fused.STATE_FIELDS:
        rows, dtype = fused.field_spec(k)
        for S_ in (Sk, Sp):
            if S_[k].dtype != dtype or S_[k].shape != (rows, B):
                fail(f"{label}: field {k} is {S_[k].dtype} {list(S_[k].shape)}")
    diff = lanes_differ(Sk, Sp, fused.STATE_FIELDS)
    if bool(diff.any()):
        bad = [k for k in fused.STATE_FIELDS
               if bool(lanes_differ(Sk, Sp, (k,)).any())]
        fail(f"{label}: fields {bad} differ in {int(diff.sum())} lanes")
    err = 0.0
    for k in fused.STATE_FIELDS:
        if Sk[k].is_floating_point():
            err = max(err, float((Sk[k] - Sp[k]).abs().max()))
            if not bool(torch.isfinite(Sk[k]).all()):
                fail(f"{label}: non-finite {k}")
    return err


def seeded_params(fused, dev, np):
    """numpy-seeded MLP params at H = HIDDEN, larger than init's so that the
    draws depend on the features (phases 7, 12, 17)."""
    from ai_safety_gridworlds_torch.ops import interop

    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED + 1)
    return interop.params_from_numpy({
        "mlp_w1": rng.normal(size=(HIDDEN, F)) / np.sqrt(F),
        "mlp_b1": rng.normal(size=(HIDDEN, 1)) * 0.1,
        "mlp_w2": rng.normal(size=(A + 1, HIDDEN)) * 0.3,
        "mlp_b2": rng.normal(size=(A + 1, 1)) * 0.1,
    }, dev)


def check_collect(label, fused, params, busy, dev, torch, pins=(),
                  starts=("init", "busy")):
    """A collection kernel against the plain collection (phases 7, 12, 17):
    teacher-forced, one kernel step from each plain state for COLLECT_STEPS
    steps from ``busy(SEED)``, then free-running COLLECT_STEPS steps from
    each of ``starts``: ``init_packed`` and ``busy(SEED + 2)``. A lane
    whose site-0 uniform lies within CDF_GAP of a cumulative softmax sum is
    exempt (at most MAX_EXEMPT_SHARE of the lane-steps); every other lane
    must agree in the state and the integer records, logp/value/boot within
    FLOAT_TOL, and at most MAX_DIVERGED_SHARE of the lanes may diverge
    free-running. Each
    (name, run) of ``pins`` also takes every teacher-forced step (``run(fn)``
    calls ``fn`` under its setting, a lane group), held to the same gate.
    Returns (largest logp/value/boot error, exempt lane-steps, exempt ones
    that differed at the default setting, {start: diverged lanes})."""
    S = busy(SEED)
    statics = fused._collect_statics(S, params)
    err_max, exempt, flipped = 0.0, 0, 0
    runs = [("", lambda fn: fn())] + list(pins)
    pin_err = {name: 0.0 for name, _ in runs}
    for k in range(COLLECT_STEPS):
        Sp, rec, ex = fused._collect_step(S, statics)
        bp = fused._bootstrap_value(Sp, statics)
        gap = (ex["pol"]["cdf_gap"] < CDF_GAP).any(dim=0)
        exempt += int(gap.sum())
        keep = ~gap
        for name, run in runs:
            Sk, tk, bk = run(lambda: fused.rollout_collect(S, params, 1))
            bad = lanes_differ(Sk, Sp, fused.STATE_FIELDS)
            bad |= lanes_differ({n: tk[n][0] for n in rec}, rec,
                                ("feats", "action", "reward", "done"))
            if bool((bad & keep).any()):
                fail(f"{label} {name} step {k}: {int((bad & keep).sum())} "
                     "non-exempt lanes differ")
            if not name:
                flipped += int((bad & gap).sum())
            err = max(
                float((tk["logp"][0] - rec["logp"]).abs()[:, keep].max()),
                float((tk["value"][0] - rec["value"]).abs().max()),
                float((bk - bp).abs()[:, keep].max()),
            )
            if err > FLOAT_TOL:
                fail(f"{label} {name} step {k}: logp/value/boot error {err} > "
                     f"{FLOAT_TOL}")
            err_max = max(err_max, err)
            pin_err[name] = max(pin_err[name], err)
        S = Sp
    if pins:
        log(f"{label} teacher-forced at " + ", ".join(
            f"{name}: error {e}" for name, e in pin_err.items() if name)
            + "; no non-exempt lane differed")
    lane_steps = BATCH * COLLECT_STEPS
    log(f"{label} teacher-forced over {COLLECT_STEPS} steps: {exempt} exempt "
        f"lane-steps of {lane_steps} (CDF margin < {CDF_GAP}), {flipped} of "
        f"them differing; logp/value/boot max error {err_max}")
    if exempt > MAX_EXEMPT_SHARE * lane_steps:
        fail(f"{label}: {exempt} exempt lane-steps exceed "
             f"{MAX_EXEMPT_SHARE:.2%}")
    diverged = {}
    for start in starts:
        if start == "init":
            S0 = fused.init_packed(SEED, BATCH, dev)
        else:
            S0 = busy(SEED + 2)
        Sk, tk, bk = fused.rollout_collect(S0, params, COLLECT_STEPS)
        Sp, tp, bp = fused.rollout_collect_plain(S0, params, COLLECT_STEPS)
        d = lanes_differ(Sk, Sp, fused.STATE_FIELDS)
        diverged[start] = int(d.sum())
        same = ~d
        log(f"{label} free-running {COLLECT_STEPS} steps from {start}: "
            f"{diverged[start]} of {BATCH} lanes diverged; logp max error on "
            f"the others {float((tk['logp'] - tp['logp']).abs()[:, :, same].max())}, "
            f"boot {float((bk - bp).abs()[:, same].max())}; actions "
            f"{int((tk['action'] >= 0).sum())} drawn, {int(tk['done'].sum())} "
            f"done flags, reward sum {float(tk['reward'].sum())}")
        if diverged[start] > MAX_DIVERGED_SHARE * BATCH:
            fail(f"{label} free-running from {start}: too many lanes diverged")
        for name in ("logp", "value", "feats", "reward"):
            if not bool(torch.isfinite(tk[name]).all()):
                fail(f"{label} trajectory {name} is not finite")
    return err_max, exempt, flipped, diverged


def device_busy_ms(fn, kernel_key, torch):
    """(device busy ms, ms in kernels whose name holds ``kernel_key``, the
    three device-busiest names with their ms) of one call of ``fn`` under
    ``torch.profiler``; (0, 0, []) where it records no device time. Only
    the device's own rows (kernels, copies, fills) count, as in
    ``device_profile``: an ATen op's row carries the time of the kernels
    it issued, which have rows of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, kernel_us, by_name = 0.0, 0.0, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_us += us
        if kernel_key in ev.key:
            kernel_us += us
        if us > 0:
            by_name.append((round(us / 1e3, 3), ev.key[:60]))
    top = sorted(by_name, reverse=True)[:3]
    return busy_us / 1e3, kernel_us / 1e3, top


def scalar_train_path(label, fused, card, reset_counts, counts, torch):
    """A scalar env's training path (phases 13 and 28): ``make_train_step(
    fused, FusedPPOConfig(n_steps=64, n_epochs=2, n_minibatches=4),
    device="cuda")`` at B = BATCH, H = HIDDEN, one warm-up step, then
    TRAIN_CALLS timed steps with the launch counters set to 0 just before and
    read just after (K5 once per step, nothing else). Returns the launch
    counts and K5's row: its time per collect, the plain collection's, the
    bound, the median step and the share outside K5."""
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops.fused_scalar import fused_scalar_collect

    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    state = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                       device="cuda")
    train_step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    state, metrics = train_step(state)  # warm-up
    torch.cuda.synchronize()
    step_s = []
    reset_counts()
    for call in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if fused_scalar_collect.launches != call + 1:
            fail("K5 did not launch once per train_step")
    train_launches = counts()
    log(f"launch counts over the {label} training path: {train_launches}")
    if (train_launches["fused_scalar_collect"] != TRAIN_CALLS
            or sum(train_launches.values()) != TRAIN_CALLS):
        fail(f"the {label} training path did not run on K5 alone")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite training metric {k}")
    env_steps = COLLECT_STEPS * BATCH
    for call, s_ in enumerate(step_s):
        log(f"{label} train_step {call}: {s_ * 1e3:.3f} ms host clock, "
            f"{env_steps / s_:.0f} training env-steps/s  [{card}]")
    params = {k: v.detach() for k, v in state.params.items()}
    S_c = state.S
    k5_ms = cuda_ms(lambda: fused.rollout_collect(S_c, params, COLLECT_STEPS),
                    3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_collect_plain(S_c, params, COLLECT_STEPS)
    torch.cuda.synchronize()
    k5_plain_ms = (time.perf_counter() - t0) * 1e3
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    busy_ms, k5_prof_ms, top = device_busy_ms(lambda: train_step(state),
                                              "sc_collect_kernel", torch)
    idle = (f"device busy {busy_ms:.3f} ms (K5 {k5_prof_ms:.3f} ms; busiest "
            f"{top}), idle share {1 - busy_ms / step_ms:.2%}" if busy_ms > 0
            else "no device time recorded by the profiler")
    log(f"K5 collect({COLLECT_STEPS}) on {fused.env.name} at B={BATCH}, "
        f"H={HIDDEN}: {k5_ms:.3f} ms; plain collection {k5_plain_ms:.3f} ms; "
        f"median {label} train_step {step_ms:.3f} ms, "
        f"{1 - k5_ms / step_ms:.2%} of it outside K5; {idle}  [{card}]")
    S_end, _, _ = fused.rollout_collect(S_c, params, COLLECT_STEPS)
    resets = scalar_resets(S_c, S_end, torch)
    k5_bytes = (2 * 4 * state_words(fused) * BATCH
                + 4 * sum(r for _, r, _ in fused._traj_layout()) * env_steps
                + 4 * BATCH + 4 * sum(v.numel() for v in params.values()))
    # The MLP runs on every lane-step (reset lanes too); the step's body on
    # acting lane-steps only.
    bound_ms, bound_by = bound(
        k5_bytes, scalar_call_ops(fused, env_steps, resets)
        + env_steps * mlp_ops(fused, HIDDEN)
    )
    return train_launches, {
        "env": fused.env.name, "launches": train_launches["fused_scalar_collect"],
        "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "step_ms": step_ms,
        "outside_share": 1 - k5_ms / step_ms,
        "idle_share": 1 - busy_ms / step_ms if busy_ms > 0 else None,
    }


def scalar_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 10-14: K4 and K5 against their plain versions, the scalar
    main path, the scalar training path and the island_navigation gate.
    Returns the ``kernels`` entries of K4 and K5."""
    from ai_safety_gridworlds_torch import ops
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import interop
    from ai_safety_gridworlds_torch.ops.fused_scalar import (
        fused_scalar_collect,
        fused_scalar_rollout,
    )

    def make(name, **kw):
        return ops.make_fused(factory.get_raw_env(name, **kw))

    # ---- 10. K4 against the plain rollout
    log("== 10. K4 fused_scalar_rollout vs plain rollout")
    k4_err = 0.0
    for label, name, kw, steps, start in K4_CHECKS:
        fused = make(name, **kw)
        if start == "init":
            S0 = fused.init_packed(SEED, BATCH, dev)
        else:
            S0 = interop.busy_scalar_state(fused, SEED, BATCH, dev)
        Sk = fused.rollout(S0, steps)
        Sp = fused.rollout_plain(S0, steps)
        k4_err = max(k4_err, rollout_equal(f"K4 {label}", fused, Sk, Sp, torch))
        eps = Sk["stats_episodes"] - S0["stats_episodes"]
        log(f"K4 {label}: {steps} steps equal in all {len(fused.STATE_FIELDS)} "
            f"fields; episodes per lane {int(eps.min())}..{int(eps.max())}, "
            f"return sums {Sk['stats_return'].sum(dim=1).tolist()}")
        if start == "init" and steps >= 300 and int(eps.min()) < 2:
            fail(f"K4 {label} did not cross two auto-resets")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail(f"K4 {label} did not cross the draw-counter wrap")
    fused = make("island_navigation")
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED)
    fused.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                       rng.normal(size=(BATCH, A)).astype(np.float32), 0.1)
    S0 = fused.init_packed(SEED, BATCH, dev)
    Sk, Sp = fused.rollout(S0, POLICY_STEPS), fused.rollout_plain(S0, POLICY_STEPS)
    k4_err = max(k4_err, rollout_equal("K4 linear policy on island_navigation",
                                       fused, Sk, Sp, torch))
    k4_linear_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    fused.set_policies(None, None)
    k4_uniform_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    log(f"K4 linear policy on island_navigation: {POLICY_STEPS} steps equal in "
        f"all fields; rollout({POLICY_STEPS}) at B={BATCH}: linear "
        f"{k4_linear_ms:.3f} ms, uniform {k4_uniform_ms:.3f} ms  [{card}]")

    # ---- 11. the scalar main path
    log("== 11. scalar main path: BatchedEnv(name, 4096, device='cuda')")
    envs = [(BatchedEnv(name, batch_size=BATCH, seed=SEED, device="cuda", **kw),
             n) for name, kw, n in SCALAR_MAIN]
    starts = [{k: v.clone() for k, v in env.state.items()} for env, _ in envs]
    torch.cuda.synchronize()
    reset_counts()
    path_s = []
    for env, n in envs:
        for call in range(MAIN_CALLS):
            before = fused_scalar_rollout.launches
            t0 = time.perf_counter()
            stats = env.rollout(n)  # fetches stats: synchronises
            path_s.append((env.name, n, time.perf_counter() - t0, stats))
            if fused_scalar_rollout.launches != before + 1:
                fail("K4 launch count did not rise by one per rollout call")
            if (env.kernel != "fused_cuda" or stats["steps"] != BATCH * n
                    or stats["episodes"] <= 0):
                fail(f"bad stats {stats}")
            if not np.isfinite(stats["sum_rewards"]).all():
                fail("non-finite reward sums")
    scalar_launches = counts()
    log(f"launch counts over the scalar main path: {scalar_launches}")
    if (scalar_launches["fused_scalar_rollout"] != MAIN_CALLS * len(envs)
            or sum(scalar_launches.values()) != MAIN_CALLS * len(envs)):
        fail("the scalar main path did not run on K4 alone, once per call")
    for name, n, sec, stats in path_s:
        log(f"{name} rollout({n}): {sec * 1e3:.3f} ms host clock, "
            f"{BATCH * n / sec:.0f} env-steps/s, {stats['episodes']} episodes, "
            f"reward sums {stats['sum_rewards'].tolist()}  [{card}]")
    k4_rows = []
    for (env, n), S_start in zip(envs, starts):
        fused = env.fused
        ms = cuda_ms(lambda: fused.rollout(S_start, n), 3, torch)
        S_end = fused.rollout(S_start, n)
        b_ms, b_by = bound(2 * 4 * state_words(fused) * BATCH,
                           scalar_call_ops(fused, BATCH * n,
                                           scalar_resets(S_start, S_end, torch)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.rollout_plain(S_start, SCALAR_PLAIN_STEPS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k4_rows.append((env.name, n, ms, plain_ms, b_ms, b_by))
        log(f"K4 {env.name} rollout({n}) at B={BATCH}: {ms:.3f} ms "
            f"({BATCH * n / ms * 1e3:.0f} env-steps/s), bound {b_ms:.4f} ms "
            f"({b_by}); plain rollout({SCALAR_PLAIN_STEPS}) {plain_ms:.3f} ms "
            f"({BATCH * SCALAR_PLAIN_STEPS / plain_ms * 1e3:.0f} env-steps/s)"
            f"  [{card}]")
        for b in SCALAR_SWEEP[1:]:
            S_b = fused.init_packed(SEED, b, dev)
            ms_b = cuda_ms(lambda: fused.rollout(S_b, n), 3, torch)
            log(f"K4 sweep: {env.name} rollout({n}) B={b}: {ms_b:.3f} ms, "
                f"{b * n / ms_b * 1e3:.0f} env-steps/s  [{card}]")
            del S_b
    # The kernels line takes the main path's first env (bench.py's scalar
    # PPO configuration) for K4's times and bound.
    _, k4_n, k4_ms, k4_plain_ms, k4_bound_ms, k4_bound_by = k4_rows[0]

    # ---- 12. K5 against the plain collection
    log("== 12. K5 fused_scalar_collect vs plain collection")
    k5_err, exempt_total, flipped_total, diverged = 0.0, 0, 0, {}
    for name in ("boat_race", "boat_race_ex"):
        fused = make(name)
        err, exempt, flipped, div = check_collect(
            f"K5 {name}", fused, seeded_params(fused, dev, np),
            lambda seed: interop.busy_scalar_state(fused, seed, BATCH, dev),
            dev, torch,
        )
        k5_err = max(k5_err, err)
        exempt_total += exempt
        flipped_total += flipped
        diverged.update({f"{name}_{k}": v for k, v in div.items()})

    # ---- 13. the scalar training path
    log("== 13. scalar training path: make_train_step(FusedBoatRace(BoatRace()), "
        f"..., device='cuda'), B={BATCH}, H={HIDDEN}")
    train_launches, k5_row = scalar_train_path("scalar", make("boat_race"),
                                               card, reset_counts, counts,
                                               torch)

    # ---- 14. the island_navigation learning gate
    log(f"== 14. learning gate: island_navigation, B=64, {GATE_UPDATES} updates")
    fused = make("island_navigation")
    gcfg = ppo_fused.FusedPPOConfig(n_steps=32, n_epochs=2, n_minibatches=2,
                                    hidden=32, lr=1e-3)
    gstate = ppo_fused.init_train_state(fused, 64, seed=3, config=gcfg,
                                        device="cuda")
    gtrain = ppo_fused.make_train_step(fused, gcfg, device="cuda")
    before = fused_scalar_collect.launches
    t0 = time.perf_counter()
    ev0 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    for _ in range(GATE_UPDATES):
        gstate, _ = gtrain(gstate)
    ev1 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    log(f"r0 {r0}  r1 {r1}  episodes {ev0['episodes']} -> {ev1['episodes']}  "
        f"({fused_scalar_collect.launches - before} K5 launches, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not (ev0["episodes"] > 50 and ev1["episodes"] > 50):
        fail("the island_navigation gate saw too few episodes")
    if not (r1 - r0 > 15.0 and r1 > 10.0):
        fail(f"the island_navigation gate failed: r0 {r0}, r1 {r1}")

    return [{
        "name": "fused_scalar_rollout", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_scalar.cu",
        "replaces": K4_REPLACES,
        "launches": scalar_launches["fused_scalar_rollout"],
        "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
        "plain_steps": SCALAR_PLAIN_STEPS, "steps": k4_n,
        "bound_ms": k4_bound_ms, "bound_by": k4_bound_by, "library_ms": None,
        "per_env": [{"env": name, "steps": n, "ms": ms, "plain_ms": pm,
                     "bound_ms": bm, "bound_by": bb}
                    for name, n, ms, pm, bm, bb in k4_rows],
    }, {
        "name": "fused_scalar_collect", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_scalar.cu",
        "replaces": K5_REPLACES,
        "launches": train_launches["fused_scalar_collect"],
        "max_abs_err": k5_err, "ms": k5_row["ms"],
        "plain_ms": k5_row["plain_ms"], "bound_ms": k5_row["bound_ms"],
        "bound_by": k5_row["bound_by"], "library_ms": None,
        "exempt_lane_steps": exempt_total, "flipped_lane_steps": flipped_total,
        "diverged_lanes": diverged, "per_env": [k5_row],
    }]


def k4_checks(label_checks, make, dev, torch, phase):
    """K4 against the plain rollout on (label, name, kw, steps, start)
    checks, every field equal (phases 25 and 29). Returns the largest float
    difference."""
    from ai_safety_gridworlds_torch.ops import interop

    k4_err = 0.0
    for label, name, kw, steps, start in label_checks:
        fused = make(name, **kw)
        if start == "init":
            S0 = fused.init_packed(SEED, BATCH, dev)
        else:
            S0 = interop.busy_scalar_state(fused, SEED, BATCH, dev)
        Sk = fused.rollout(S0, steps)
        Sp = fused.rollout_plain(S0, steps)
        k4_err = max(k4_err, rollout_equal(f"K4 {label}", fused, Sk, Sp, torch))
        eps = Sk["stats_episodes"] - S0["stats_episodes"]
        drawn = ""
        if fused.RESET_SITES:
            k = fused.EXTRA_FIELDS[0]
            drawn = f"; {k} values at the end {Sk[k].unique().tolist()[:8]}"
        log(f"K4 {label}: {steps} steps equal in all {len(fused.STATE_FIELDS)} "
            f"fields; episodes per lane {int(eps.min())}..{int(eps.max())}, "
            f"return sums {Sk['stats_return'].sum(dim=1).tolist()}{drawn}")
        if start == "init" and steps >= 300 and int(eps.min()) < 2:
            fail(f"K4 {label} did not cross two auto-resets (phase {phase})")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail(f"K4 {label} did not cross the draw-counter wrap")
    return k4_err


def k4_linear_check(label, fused, dev, card, np, torch):
    """K4's linear branch against the plain rollout over POLICY_STEPS steps
    with numpy-seeded per-lane W, b and eps = 0.1 (phases 25 and 29), and
    its time with and without the policy. Returns the largest error."""
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED)
    fused.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                       rng.normal(size=(BATCH, A)).astype(np.float32), 0.1)
    S0 = fused.init_packed(SEED, BATCH, dev)
    Sk, Sp = fused.rollout(S0, POLICY_STEPS), fused.rollout_plain(S0, POLICY_STEPS)
    err = rollout_equal(f"K4 linear policy on {label}", fused, Sk, Sp, torch)
    linear_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    fused.set_policies(None, None)
    uniform_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    log(f"K4 linear policy on {label}: {POLICY_STEPS} steps equal in all "
        f"fields; rollout({POLICY_STEPS}) at B={BATCH}: linear "
        f"{linear_ms:.3f} ms, uniform {uniform_ms:.3f} ms  [{card}]")
    return err


def scalar_main_paths(paths, n, card, np, torch, reset_counts, counts,
                      sweep=None):
    """``BatchedEnv(name, batch_size=BATCH, device="cuda").rollout(n)``
    MAIN_CALLS times for each (label, name, kw) of ``paths``, with the launch
    counters set to 0 just before and read just after each path (K4 once
    per call, nothing else); then K4's time, the bound and the plain
    version's time at SCALAR_PLAIN_STEPS (phases 26 and 30), and K4 by lane
    count on the path labelled ``sweep``. Returns K4's rows."""
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.ops.fused_scalar import fused_scalar_rollout

    rows = []
    for label, name, kw in paths:
        env = BatchedEnv(name, batch_size=BATCH, seed=SEED, device="cuda", **kw)
        S_start = {k: v.clone() for k, v in env.state.items()}
        torch.cuda.synchronize()
        reset_counts()
        call_s = []
        for call in range(MAIN_CALLS):
            t0 = time.perf_counter()
            stats = env.rollout(n)  # fetches stats: synchronises
            call_s.append(time.perf_counter() - t0)
            if fused_scalar_rollout.launches != call + 1:
                fail("K4 launch count did not rise by one per rollout call")
            if (env.kernel != "fused_cuda" or stats["steps"] != BATCH * n
                    or stats["episodes"] <= 0):
                fail(f"bad stats {stats}")
            if not np.isfinite(stats["sum_rewards"]).all():
                fail("non-finite reward sums")
        launches = counts()
        log(f"launch counts over the {label} main path: {launches}")
        if (launches["fused_scalar_rollout"] != MAIN_CALLS
                or sum(launches.values()) != MAIN_CALLS):
            fail(f"the {label} main path did not run on K4 alone, once per call")
        fused = env.fused
        ms = cuda_ms(lambda: fused.rollout(S_start, n), 3, torch)
        S_end = fused.rollout(S_start, n)
        resets = scalar_resets(S_start, S_end, torch)
        b_ms, b_by = bound(2 * 4 * state_words(fused) * BATCH,
                           scalar_call_ops(fused, BATCH * n, resets))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.rollout_plain(S_start, SCALAR_PLAIN_STEPS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for call, s_ in enumerate(call_s):
            log(f"{label} rollout({n}) call {call}: {s_ * 1e3:.3f} ms host "
                f"clock, {BATCH * n / s_:.0f} env-steps/s, host share "
                f"{1 - ms / (s_ * 1e3):.2%}  [{card}]")
        log(f"K4 {label} rollout({n}) at B={BATCH}: {ms:.3f} ms "
            f"({BATCH * n / ms * 1e3:.0f} env-steps/s; {resets} resets), bound "
            f"{b_ms:.4f} ms ({b_by}); plain rollout({SCALAR_PLAIN_STEPS}) "
            f"{plain_ms:.3f} ms ({BATCH * SCALAR_PLAIN_STEPS / plain_ms * 1e3:.0f}"
            f" env-steps/s)  [{card}]")
        rows.append({
            "env": label, "steps": n, "ms": ms, "plain_ms": plain_ms,
            "plain_steps": SCALAR_PLAIN_STEPS, "bound_ms": b_ms,
            "bound_by": b_by, "launches": launches["fused_scalar_rollout"],
            "call_ms": [s_ * 1e3 for s_ in call_s],
        })
        if label == sweep:
            for b in SCALAR_SWEEP[1:]:
                S_b = fused.init_packed(SEED, b, S_start["t"].device)
                ms_b = cuda_ms(lambda: fused.rollout(S_b, n), 3, torch)
                log(f"K4 sweep: {label} rollout({n}) B={b}: {ms_b:.3f} ms, "
                    f"{b * n / ms_b * 1e3:.0f} env-steps/s  [{card}]")
                del S_b
    return rows


def scalar_collect_checks(names, make, dev, np, torch):
    """K5 against the plain collection on each (label, name, kw) of
    ``names`` (phases 27 and 31). Returns the largest error and the counts
    of exempt, flipped and diverged lanes."""
    from ai_safety_gridworlds_torch.ops import interop

    k5_err, collect = 0.0, {"exempt": 0, "flipped": 0, "diverged": {}}
    for label, name, kw in names:
        fused = make(name, **kw)
        err, exempt, flipped, div = check_collect(
            f"K5 {label}", fused, seeded_params(fused, dev, np),
            lambda seed: interop.busy_scalar_state(fused, seed, BATCH, dev),
            dev, torch,
        )
        k5_err = max(k5_err, err)
        collect["exempt"] += exempt
        collect["flipped"] += flipped
        collect["diverged"].update({f"{label}_{k}": v for k, v in div.items()})
    return k5_err, collect


def scalar_ex_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 25-28: K4 against the plain rollout on island_navigation_ex
    and the bodies with a per-episode draw, their main paths, K5 on two of
    them and the island_navigation_ex training path. Returns K4's largest
    error and its rows by main path, and K5's largest error, its collection
    counts and its training path's launches and row."""
    from ai_safety_gridworlds_torch import ops
    from ai_safety_gridworlds_torch.helpers import factory

    def make(name, **kw):
        return ops.make_fused(factory.get_raw_env(name, **kw))

    # ---- 25. K4 against the plain rollout on the new bodies
    log("== 25. K4 fused_scalar_rollout vs plain rollout: island_navigation_ex "
        "and the per-episode draws")
    k4_err = k4_checks(K4_NEW_CHECKS, make, dev, torch, 25)
    k4_err = max(k4_err, k4_linear_check(
        "island_navigation_ex", make("island_navigation_ex"), dev, card, np,
        torch))

    # ---- 26. the new scalar main paths
    n = SCALAR_NEW_STEPS
    log(f"== 26. scalar main paths: BatchedEnv(name, 4096, device='cuda')"
        f".rollout({n})")
    k4_rows = scalar_main_paths(SCALAR_NEW_MAIN, n, card, np, torch,
                                reset_counts, counts,
                                sweep="island_navigation_ex")

    # ---- 27. K5 against the plain collection
    log("== 27. K5 fused_scalar_collect vs plain collection: "
        "island_navigation_ex, absent_supervisor")
    k5_err, collect = scalar_collect_checks(
        [(name, name, {}) for name in ("island_navigation_ex",
                                       "absent_supervisor")],
        make, dev, np, torch)

    # ---- 28. the island_navigation_ex training path
    log("== 28. island_navigation_ex training path: make_train_step("
        "FusedIslandNavEx(IslandNavigationEx()), ..., device='cuda'), "
        f"B={BATCH}, H={HIDDEN}")
    train_launches, k5_row = scalar_train_path(
        "island_navigation_ex", make("island_navigation_ex"), card,
        reset_counts, counts, torch)
    return k4_err, k4_rows, k5_err, collect, train_launches, k5_row


def scalar_last_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 29-32: K4 against the plain rollout on the last slice's bodies
    (the 18 configurations, from init and busy states, and the linear
    branch), their main paths, K5 on three of them and the
    side_effects_sokoban training path. Returns as ``scalar_ex_phases``."""
    from ai_safety_gridworlds_torch import ops
    from ai_safety_gridworlds_torch.helpers import factory

    def make(name, **kw):
        return ops.make_fused(factory.get_raw_env(name, **kw))

    # ---- 29. K4 against the plain rollout on the last slice's bodies
    log("== 29. K4 fused_scalar_rollout vs plain rollout: the last slice's "
        "18 configurations")
    checks = tuple(
        (label + suffix, name, kw, steps, start)
        for label, name, kw in LAST_BODIES
        for suffix, steps, start in (("", 300, "init"), ("_busy", 100, "busy"))
    )
    k4_err = k4_checks(checks, make, dev, torch, 29)
    for label, name, kw in (("side_effects_sokoban level 1",
                             "side_effects_sokoban", {"level": 1}),
                            ("tomato_watering", "tomato_watering", {})):
        k4_err = max(k4_err, k4_linear_check(label, make(name, **kw), dev,
                                             card, np, torch))

    # ---- 30. the last slice's main paths
    n = SCALAR_NEW_STEPS
    log(f"== 30. the last slice's main paths: BatchedEnv(name, 4096, "
        f"device='cuda').rollout({n})")
    k4_rows = scalar_main_paths(LAST_MAIN, n, card, np, torch, reset_counts,
                                counts)

    # ---- 31. K5 against the plain collection
    log("== 31. K5 fused_scalar_collect vs plain collection: "
        "side_effects_sokoban level 1, tomato_watering, friend_foe")
    k5_err, collect = scalar_collect_checks(
        (("side_effects_sokoban_l1", "side_effects_sokoban", {"level": 1}),
         ("tomato_watering", "tomato_watering", {}),
         ("friend_foe", "friend_foe", {})),
        make, dev, np, torch)

    # ---- 32. the side_effects_sokoban training path
    log("== 32. side_effects_sokoban training path: make_train_step("
        "FusedSokoban(SideEffectsSokoban(level=1)), ..., device='cuda'), "
        f"B={BATCH}, H={HIDDEN}")
    train_launches, k5_row = scalar_train_path(
        "side_effects_sokoban", make("side_effects_sokoban", level=1), card,
        reset_counts, counts, torch)
    return k4_err, k4_rows, k5_err, collect, train_launches, k5_row


# Operations of the island_navigation_ex_ma step, counted from
# fused_island_ma.cu. Per lane-step: each agent's action draw (PRF hash 21,
# uniform01 3, scale, floor, convert, add, clamp 6), each Fisher-Yates swap
# (hash 21, uniform01 3, floor and clamp 5), and per agent the finalize
# (game-over, type and done 8) and its D stats adds. Per acting agent
# sub-step: the direction tables (6), the move (row and column 3, two delta
# reads and adds 4, bounds 7, clamped candidate 6, wall read and test 2, the
# move test and put 5), the sboard read and code_of (5), the movement reward
# and safety (2), satiation and death tests (6), goal, drink, food, gold and
# silver tests with the visit and availability arithmetic (24), the gap test
# (4), homeostasis (6), the reset of the availabilities (2): 78; 2 operations
# per agent for the occupancy and gap tests and 5 for its drape code_of and
# water test; and about 3 reward rows of D adds.
ISLAND_DRAW_OPS = 30
ISLAND_SWAP_OPS = 29
ISLAND_FINALIZE_OPS = 8
ISLAND_SUBSTEP_OPS = 78
ISLAND_SUBSTEP_OPS_PER_AGENT = 2 + 2 + 5
ISLAND_SUBSTEP_REWARD_ROWS = 3


def island_step_ops(fused, lane_steps, acting_substeps):
    """Operations of ``lane_steps`` island lane-steps with
    ``acting_substeps`` acting agent sub-steps among them."""
    n, D = fused.n, fused.D
    per_step = (n * ISLAND_DRAW_OPS + (n - 1) * ISLAND_SWAP_OPS
                + n * (ISLAND_FINALIZE_OPS + D))
    per_substep = (ISLAND_SUBSTEP_OPS + n * ISLAND_SUBSTEP_OPS_PER_AGENT
                   + ISLAND_SUBSTEP_REWARD_ROWS * D)
    return lane_steps * per_step + acting_substeps * per_substep


def island_acting(fused, S, n_steps, torch, params=None):
    """(acting agent sub-steps, final state) of ``n_steps`` plain steps
    from ``S``: the agents that draw an action (not a reset lane, not
    dead)."""
    acting = 0
    for _ in range(n_steps):
        S, ex = fused.step(S, collect_draws=True, params=params)
        acting += int((ex["actions"] >= 0).sum())
    return acting, S


def with_island_group(g, fn):
    """``fn()`` with K6/K7's lane group pinned to g threads a lane (None:
    the pick of ``fused_island_ma._lanes_per_group``)."""
    from ai_safety_gridworlds_torch.ops import fused_island_ma

    fused_island_ma._LANES_PER_GROUP = g
    try:
        return fn()
    finally:
        fused_island_ma._LANES_PER_GROUP = None


def island_pick(fused, batch, hidden=0):
    """The lane group K6 (K7 with ``hidden``) picks at ``batch`` on this
    card."""
    import torch

    from ai_safety_gridworlds_torch.ops import fused_island_ma
    from ai_safety_gridworlds_torch.ops.fused_scalar import _schedulers

    return fused_island_ma._lanes_per_group(
        fused, batch, hidden=hidden,
        schedulers=_schedulers(str(torch.device("cuda", 0))))


def island_group_sweep(card, torch, collect=False, check=True):
    """Phase 35 (and ``--sweep-island``): K6 per rollout(MAIN_STEPS) on the
    island main path at ISLAND_GROUP_BATCHES, or with ``collect`` K7 per
    collect(COLLECT_STEPS) at H = HIDDEN at ISLAND_COLLECT_BATCHES, with the
    lane group ``fused_island_ma._lanes_per_group`` picks there first and
    last (the two readings give the run's spread) and each of ISLAND_GROUPS
    between. With ``check`` every K6 state is bit-equal to the plain
    version's at B = BATCH and to the pick's at the larger B (phase 15
    holds K6 at each g against the plain rollout), and every K7 output
    (state, records, boot) bit-equal to the pick's (phase 17 holds K7 at
    each g against the plain collection).
    Returns {B: {g: [ms, ...]}} and logs the cycles a lane-step."""
    import numpy as np

    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa

    dev = torch.device("cuda", 0)
    kernel = "K7" if collect else "K6"
    steps = COLLECT_STEPS if collect else MAIN_STEPS
    mhz = sm_clock_max_mhz()
    fused = FusedIslandMa(IslandNavigationExMa())
    params = seeded_params(fused, dev, np) if collect else None
    sweep = {}
    for b in ISLAND_COLLECT_BATCHES if collect else ISLAND_GROUP_BATCHES:
        S0 = fused.init_packed(SEED, b, dev)
        if collect:
            def run():
                return fused.rollout_collect(S0, params, steps)
        else:
            def run():
                return fused.rollout(S0, steps)
        plain = check and not collect and b == BATCH
        ref = fused.rollout_plain(S0, steps) if plain else None
        pick = island_pick(fused, b, HIDDEN if collect else 0)
        times = {}
        for g in (pick,) + ISLAND_GROUPS + (pick,):
            if check:
                got = with_island_group(g, run)
                if ref is None:
                    ref = got
                if collect:
                    S_, traj, boot = got
                    for name, x in {**S_, **traj, "boot": boot}.items():
                        y = {**ref[0], **ref[1], "boot": ref[2]}[name]
                        if x.is_floating_point():
                            x, y = x.view(torch.int32), y.view(torch.int32)
                        if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                            fail(f"K7 {name} at g={g}, B={b} differs from "
                                 f"g={pick}")
                else:
                    rollout_equal(f"K6 B={b} at g={g}", fused, got, ref, torch)
                del got
            times.setdefault(g, []).append(
                with_island_group(g, lambda: cuda_ms(run, 3, torch)))
        sweep[b] = times
        first = times[pick]
        log(f"{kernel} {'collect' if collect else 'rollout'}({steps}) at B={b} "
            "by threads a lane: " + ", ".join(
                f"{k}: " + " / ".join(f"{t:.3f}" for t in v)
                for k, v in times.items())
            + f" ms; the pick {pick}, its spread "
            f"{abs(first[-1] - first[0]) / min(first):.2%}, "
            f"{min(first) * 1e-3 * mhz * 1e6 / steps:.0f} cycles a lane-step at "
            f"{mhz:.0f} MHz"
            + ("; each equal to the plain version's" if plain
               else "; each equal to the pick's" if check else "")
            + f"  [{card}]")
        del S0, ref
    return sweep


def island_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 15-19: K6 and K7 against their plain versions, the island main
    path with K6's lane sweep, the island training path and the island
    learning gate. Returns the ``kernels`` entries of K6 and K7."""
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import interop
    from ai_safety_gridworlds_torch.ops.fused_island_ma import (
        FusedIslandMa,
        fused_island_ma_collect,
        fused_island_ma_rollout,
    )

    # ---- 15. K6 against the plain rollout
    log("== 15. K6 fused_island_ma_rollout vs plain rollout, at the picked "
        f"lane group and at {ISLAND_GROUPS} threads a lane")
    k6_err = 0.0
    for label, kw, K, steps, start, batch in K6_CHECKS + (
            ("ragged", {}, 1, 300, "init", BATCH + 3),):
        fused = FusedIslandMa(IslandNavigationExMa(**kw))
        if start == "init":
            S0 = fused.init_packed(SEED, batch, dev, layout_pool=K)
        else:
            fused.layout_pool = K
            S0 = interop.busy_island_ma_state(fused, SEED, batch, dev)
        Sp = fused.rollout_plain(S0, steps)
        for g in (None,) + ISLAND_GROUPS:
            Sk = with_island_group(g, lambda: fused.rollout(S0, steps))
            k6_err = max(k6_err, rollout_equal(
                f"K6 {label} at {g or 'the pick'}", fused, Sk, Sp, torch))
        eps = Sk["stats_episodes"] - S0["stats_episodes"]
        regrown = int((Sk["drink_frac"] != 0).sum() + (Sk["food_frac"] != 0).sum())
        log(f"K6 {label} (B={batch}): {steps} steps equal in all "
            f"{len(fused.STATE_FIELDS)} fields at the pick "
            f"(g={island_pick(fused, batch)}) and at every g; episodes per "
            f"lane {int(eps.min())}..{int(eps.max())}; reward sums "
            f"{Sk['stats_rewards'].sum(dim=1).tolist()}; lanes with a "
            f"regrowth fraction {regrown}")
        if start == "init" and K == 1 and int(eps.min()) < 2:
            fail(f"K6 {label} did not cross two auto-resets")
        if label == "rich" and regrown == 0:
            fail("K6 rich: no regrowth ran")
        if K > 1 and int(Sk["ep_idx"].max()) < K:
            fail(f"K6 {label} did not cycle the layout pool")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail(f"K6 {label} did not cross the draw-counter wrap")
    fused = FusedIslandMa(IslandNavigationExMa())
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED)
    fused.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                       rng.normal(size=(BATCH, A)).astype(np.float32), 0.1)
    S0 = fused.init_packed(SEED, BATCH, dev)
    Sp = fused.rollout_plain(S0, POLICY_STEPS)
    pol_before = fused_island_ma_rollout.launches
    for g in (None,) + ISLAND_GROUPS:
        Sk = with_island_group(g, lambda: fused.rollout(S0, POLICY_STEPS))
        k6_err = max(k6_err, rollout_equal(
            f"K6 linear policy at {g or 'the pick'}", fused, Sk, Sp, torch))
    k6_pol_launches = fused_island_ma_rollout.launches - pol_before
    k6_linear_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    fused.set_policies(None, None)
    k6_uniform_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    log(f"K6 linear policy: {POLICY_STEPS} steps equal in all fields at the "
        f"pick and at every g; rollout({POLICY_STEPS}) at B={BATCH}: linear "
        f"{k6_linear_ms:.3f} ms, uniform {k6_uniform_ms:.3f} ms  [{card}]")

    # ---- 16. the island main path
    log("== 16. island main path: BatchedEnv('island_navigation_ex_ma', 4096, "
        "device='cuda')")
    env = BatchedEnv("island_navigation_ex_ma", batch_size=BATCH, seed=SEED,
                     device="cuda")
    if env.kernel != "fused_cuda":
        fail(f"BatchedEnv reports kernel {env.kernel!r}")
    fused = env.fused
    S_start = {k: v.clone() for k, v in env.state.items()}
    torch.cuda.synchronize()
    reset_counts()
    call_s = []
    for call in range(MAIN_CALLS):
        t0 = time.perf_counter()
        stats = env.rollout(MAIN_STEPS)  # fetches stats: synchronises
        call_s.append(time.perf_counter() - t0)
        if fused_island_ma_rollout.launches != call + 1:
            fail("K6 launch count did not rise by one per rollout call")
        if (stats["steps"] != BATCH * MAIN_STEPS or stats["episodes"] <= 0
                or not np.isfinite(stats["sum_rewards"]).all()):
            fail(f"bad stats {stats}")
    island_launches = counts()
    log(f"launch counts over the island main path: {island_launches}")
    if (island_launches["fused_island_ma_rollout"] != MAIN_CALLS
            or sum(island_launches.values()) != MAIN_CALLS):
        fail("the island main path did not run on K6 alone, once per call")
    k6_ms = cuda_ms(lambda: fused.rollout(S_start, MAIN_STEPS), 5, torch)
    for call, s_ in enumerate(call_s):
        log(f"island rollout call {call}: {s_ * 1e3:.3f} ms host clock, "
            f"{BATCH * MAIN_STEPS / s_:.0f} env-steps/s, host share "
            f"{1 - k6_ms / (s_ * 1e3):.2%} beside K6's {k6_ms:.3f} ms  [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_plain(S_start, PLAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    k6_plain_ms = ((time.perf_counter() - t0) * 1e3 * MAIN_STEPS
                   / PLAIN_TIMED_STEPS)
    acting, _ = island_acting(fused, S_start, MAIN_STEPS, torch)
    # Bytes: the state read and written once, and two 4-byte board reads
    # per acting sub-step.
    k6_bound_ms, k6_bound_by = bound(
        2 * 4 * state_words(fused) * BATCH + 8 * acting,
        island_step_ops(fused, BATCH * MAIN_STEPS, acting),
    )
    log(f"K6 rollout({MAIN_STEPS}) at B={BATCH}: {k6_ms:.3f} ms "
        f"({BATCH * MAIN_STEPS / k6_ms * 1e3:.0f} env-steps/s), {acting} acting "
        f"sub-steps, bound {k6_bound_ms:.5f} ms ({k6_bound_by}); plain "
        f"{k6_plain_ms:.3f} ms ({PLAIN_TIMED_STEPS} steps scaled)  [{card}]")
    for b in ISLAND_SWEEP:
        S_b = fused.init_packed(SEED, b, dev)
        ms_b = cuda_ms(lambda: fused.rollout(S_b, MAIN_STEPS), 3, torch)
        log(f"K6 sweep: rollout({MAIN_STEPS}) B={b}: {ms_b:.3f} ms, "
            f"{b * MAIN_STEPS / ms_b * 1e3:.0f} env-steps/s  [{card}]")
        del S_b

    # ---- 17. K7 against the plain collection
    log("== 17. K7 fused_island_ma_collect vs plain collection")
    fused = FusedIslandMa(IslandNavigationExMa())
    k7_err, exempt, flipped, diverged = check_collect(
        "K7", fused, seeded_params(fused, dev, np),
        lambda seed: interop.busy_island_ma_state(fused, seed, BATCH, dev),
        dev, torch,
        pins=[(f"g={g}", lambda fn, g=g: with_island_group(g, fn))
              for g in ISLAND_GROUPS],
    )

    # ---- 18. the island training path
    log("== 18. island training path: make_train_step(FusedIslandMa("
        f"IslandNavigationExMa()), ..., device='cuda'), B={BATCH}, H={HIDDEN}")
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    fused = FusedIslandMa(IslandNavigationExMa())
    state = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                       device="cuda")
    train_step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    state, metrics = train_step(state)  # warm-up
    torch.cuda.synchronize()
    step_s = []
    reset_counts()
    for call in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if fused_island_ma_collect.launches != call + 1:
            fail("K7 did not launch once per train_step")
    train_launches = counts()
    log(f"launch counts over the island training path: {train_launches}")
    if (train_launches["fused_island_ma_collect"] != TRAIN_CALLS
            or sum(train_launches.values()) != TRAIN_CALLS):
        fail("the island training path did not run on K7 alone")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite training metric {k}")
    env_steps = COLLECT_STEPS * BATCH
    for call, s_ in enumerate(step_s):
        log(f"island train_step {call}: {s_ * 1e3:.3f} ms host clock, "
            f"{env_steps / s_:.0f} training env-steps/s  [{card}]")
    params = {k: v.detach() for k, v in state.params.items()}
    S_c = state.S
    k7_ms = cuda_ms(lambda: fused.rollout_collect(S_c, params, COLLECT_STEPS),
                    3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_collect_plain(S_c, params, COLLECT_STEPS)
    torch.cuda.synchronize()
    k7_plain_ms = (time.perf_counter() - t0) * 1e3
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    busy_ms, k7_prof_ms, top = device_busy_ms(lambda: train_step(state),
                                              "im_collect_kernel", torch)
    idle = (f"device busy {busy_ms:.3f} ms (K7 {k7_prof_ms:.3f} ms; busiest "
            f"{top}), idle share {1 - busy_ms / step_ms:.2%}" if busy_ms > 0
            else "no device time recorded by the profiler")
    log(f"K7 collect({COLLECT_STEPS}) at B={BATCH}, H={HIDDEN}: {k7_ms:.3f} ms; "
        f"plain collection {k7_plain_ms:.3f} ms; median island train_step "
        f"{step_ms:.3f} ms, {1 - k7_ms / step_ms:.2%} of it outside K7; "
        f"{idle}  [{card}]")
    acting, _ = island_acting(fused, S_c, COLLECT_STEPS, torch, params=params)
    k7_bytes = (2 * 4 * state_words(fused) * BATCH + 8 * acting
                + 4 * sum(r for _, r, _ in fused._traj_layout()) * env_steps
                + 4 * fused.n * BATCH
                + 4 * sum(v.numel() for v in params.values()))
    # The MLP runs for every agent on every lane-step (reset lanes too).
    k7_bound_ms, k7_bound_by = bound(
        k7_bytes, island_step_ops(fused, env_steps, acting)
        + fused.n * env_steps * mlp_ops(fused, HIDDEN)
    )

    # ---- 19. the island learning gate
    log(f"== 19. learning gate: island_navigation_ex_ma, B=64, {GATE_UPDATES} "
        "updates")
    fused = FusedIslandMa(IslandNavigationExMa())
    gcfg = ppo_fused.FusedPPOConfig(n_steps=32, n_epochs=2, n_minibatches=2,
                                    hidden=32, lr=1e-3)
    gstate = ppo_fused.init_train_state(fused, 64, seed=3, config=gcfg,
                                        device="cuda")
    gtrain = ppo_fused.make_train_step(fused, gcfg, device="cuda")
    before = fused_island_ma_collect.launches
    t0 = time.perf_counter()
    ev0 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    for _ in range(GATE_UPDATES):
        gstate, _ = gtrain(gstate)
    ev1 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    log(f"r0 {r0}  r1 {r1}  episodes {ev0['episodes']} -> {ev1['episodes']}  "
        f"({fused_island_ma_collect.launches - before} K7 launches, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not (ev0["episodes"] > 50 and ev1["episodes"] > 50):
        fail("the island_navigation_ex_ma gate saw too few episodes")
    if not (r1 - r0 > 30.0 and r1 > -10.0):
        fail(f"the island_navigation_ex_ma gate failed: r0 {r0}, r1 {r1}")

    return [{
        "name": "fused_island_ma_rollout", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_island_ma.cu",
        "replaces": K6_REPLACES,
        "launches": island_launches["fused_island_ma_rollout"],
        "policy_search_launches": k6_pol_launches,
        "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound_ms, "bound_by": k6_bound_by, "library_ms": None,
    }, {
        "name": "fused_island_ma_collect", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_island_ma.cu",
        "replaces": K7_REPLACES,
        "launches": train_launches["fused_island_ma_collect"],
        "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
        "bound_ms": k7_bound_ms, "bound_by": k7_bound_by, "library_ms": None,
        "exempt_lane_steps": exempt, "flipped_lane_steps": flipped,
        "diverged_lanes": diverged,
    }], island_launches["prf_words"] + train_launches["prf_words"]


# Operations of the aintelope_savanna step, counted from fused_savanna.cu.
# Per lane-step: each agent's action draw and Fisher-Yates swap and finalize,
# as on island (ISLAND_DRAW_OPS, ISLAND_SWAP_OPS, ISLAND_FINALIZE_OPS). Per
# acting agent sub-step: the direction tables (4), the move (candidate,
# clamp, wall read and test, the move test and puts 12, 2 per agent for the
# occupancy), the sboard read and decode (5), the predator and curtain reads
# (2 + 1 per resource), satiation and death tests (8), the four resources'
# consumption tests and arithmetic (24), the NON_DRINK/NON_FOOD tests (4),
# gold and silver tests and visits (8, and 2 logs, a subtraction and a
# division when paid), the gap test (6), homeostasis (12), safety and water
# (4): 95, 2 per agent, and about 3 reward rows of D adds.
SAVANNA_SUBSTEP_OPS = 95
SAVANNA_SUBSTEP_OPS_PER_AGENT = 2
SAVANNA_SUBSTEP_REWARD_ROWS = 3
# Per-cell passes, as the least work of the function (each cell's random
# word hashed once, however often an implementation rehashes it): the
# predator distance (read, test, row and column, Manhattan distance,
# minimum: 6 per cell) on each acting sub-step with predators; the walk (the
# marking pass reads and tests every cell, 3, and hashes each predator, 27
# with uniform01 and the test; four direction passes of two loops of 3; the
# final pass 2); a drape's count pass (2 per cell); a drape that removes or
# spawns tiles hashes and scores every cell once (the hash 21 and the score
# 10), compares every cell once per pick (2) and applies (2 per cell); the
# redraw (clearing 6 per cell, hashing and scoring the interior once, 27
# per cell, comparing it once per pick, 2 per cell, each water pick a
# distance pass at 8 per cell). PR 10's count hashed every cell again at
# each drape pick and apply (31 per cell each) and at each redraw pick.
SAFETY2_OPS_PER_CELL = 6
WALK_OPS_PER_CELL = 3 + 4 * 2 * 3 + 2
WALK_OPS_PER_PREDATOR = 27
DRAPE_COUNT_OPS_PER_CELL = 2
DRAPE_SCORE_OPS_PER_CELL = 31
DRAPE_PICK_OPS_PER_CELL = 2
DRAPE_APPLY_OPS_PER_CELL = 2
REDRAW_CLEAR_OPS_PER_CELL = 6
REDRAW_SCORE_OPS_PER_CELL = 27
REDRAW_PICK_OPS_PER_CELL = 2
REDRAW_WATER_OPS_PER_CELL = 8


def savanna_work(fused, S, n_steps, torch, params=None):
    """What ``n_steps`` plain savanna steps from ``S`` do, counted from
    their draws: acting agent sub-steps, lane-steps in which an agent acts
    (the round's last agent walks the predators once a step), redraws,
    drape count passes, drape picks (cells a drape removed or spawned), and
    drapes that applied picks. Returns (counts dict, final state)."""
    res = [sp["name"] for sp in fused.res_specs
           if fused.sustain and not sp["use_metric"]]
    w = dict(acting=0, acting_steps=0, redraws=0, drape_passes=0,
             drape_picks=0, drape_applies=0)
    for _ in range(n_steps):
        before = {nm: S["res_" + nm] > 0.5 for nm in res}
        S, ex = fused.step(S, collect_draws=True, params=params)
        acting = ex["actions"] >= 0
        w["acting"] += int(acting.sum())
        w["acting_steps"] += int(acting.any(dim=0).sum())
        if fused.exact_reset:
            w["redraws"] += int(ex["over"].sum())
        w["drape_passes"] += int(acting.sum()) * len(res)
        keep = ~ex["over"][0]
        for nm in res:
            prev = before[nm]
            for k, slot in enumerate(ex["slots"]):
                now = slot[nm + "_after"]
                changed = (now != prev).sum(dim=0)
                if k == 0:
                    changed = changed * keep  # a reset is no drape
                w["drape_picks"] += int(changed.sum())
                w["drape_applies"] += int((changed > 0).sum())
                prev = now
    return w, S


def savanna_step_ops(fused, lane_steps, w):
    """Operations of ``lane_steps`` savanna lane-steps with the per-cell
    work ``w`` of ``savanna_work``."""
    n, D, HW = fused.n, fused.D, fused.HW
    env = fused.env
    per_step = (n * ISLAND_DRAW_OPS + (n - 1) * ISLAND_SWAP_OPS
                + n * (ISLAND_FINALIZE_OPS + D))
    per_substep = (SAVANNA_SUBSTEP_OPS + n * SAVANNA_SUBSTEP_OPS_PER_AGENT
                   + SAVANNA_SUBSTEP_REWARD_ROWS * D)
    ops = lane_steps * per_step + w["acting"] * per_substep
    if env._has_predators:
        n_pred = sum(1 for kind, _ in fused._placement_spec if kind == "predator")
        ops += w["acting"] * HW * SAFETY2_OPS_PER_CELL
        ops += w["acting_steps"] * (HW * WALK_OPS_PER_CELL
                                    + n_pred * WALK_OPS_PER_PREDATOR)
    ops += w["drape_passes"] * HW * DRAPE_COUNT_OPS_PER_CELL
    ops += w["drape_applies"] * HW * (DRAPE_SCORE_OPS_PER_CELL
                                      + DRAPE_APPLY_OPS_PER_CELL)
    ops += w["drape_picks"] * HW * DRAPE_PICK_OPS_PER_CELL
    if w["redraws"]:
        T = len(fused._placement_spec)
        n_water = sum(1 for kind, _ in fused._placement_spec if kind == "water")
        interior = (fused.h - 2) * (fused.w - 2)
        ops += w["redraws"] * (HW * REDRAW_CLEAR_OPS_PER_CELL
                               + interior * REDRAW_SCORE_OPS_PER_CELL
                               + T * interior * REDRAW_PICK_OPS_PER_CELL
                               + n_water * HW * REDRAW_WATER_OPS_PER_CELL)
    return ops


def savanna_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 20-24: K8 and K9 against their plain versions (K8 at every
    lane group size), the savanna main path (default and sustainability)
    with K8's lane sweep, the savanna training path and the savanna learning
    gate. Returns the ``kernels`` entries of K8 and K9 and the K2 launches
    of the driven paths."""
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import fused_savanna, interop
    from ai_safety_gridworlds_torch.ops.fused_savanna import (
        FusedSavanna,
        fused_savanna_collect,
        fused_savanna_rollout,
    )

    # ---- 20. K8 against the plain rollout
    log("== 20. K8 fused_savanna_rollout vs plain rollout, at the lane group "
        f"the batch picks and at {SAVANNA_GROUPS} threads a lane")
    k8_err = 0.0
    for label, kw, K, steps, start in K8_CHECKS:
        fused = FusedSavanna(AIntelopeSavanna(**kw))
        S0 = fused.init_packed(SEED, BATCH, dev, layout_pool=K)
        if start == "busy":
            S0 = interop.busy_savanna_state(fused, SEED, BATCH, dev)
        t0 = time.perf_counter()
        Sk = fused.rollout(S0, steps)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        Sp = fused.rollout_plain(S0, steps)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        k8_err = max(k8_err, rollout_equal(f"K8 {label}", fused, Sk, Sp, torch))
        try:
            for g in SAVANNA_GROUPS:
                fused_savanna._LANES_PER_GROUP = g
                k8_err = max(k8_err, rollout_equal(
                    f"K8 {label} at {g} threads a lane", fused,
                    fused.rollout(S0, steps), Sp, torch))
        finally:
            fused_savanna._LANES_PER_GROUP = None
        eps = Sk["stats_episodes"] - S0["stats_episodes"]
        moved = int((Sk["predator"] != S0["predator"]).any(dim=0).sum())
        redrawn = (int((Sk["sboard"] != S0["sboard"]).any(dim=0).sum())
                   if fused.exact_reset else 0)
        log(f"K8 {label}: {steps} steps equal in all {len(fused.STATE_FIELDS)} "
            f"fields at {fused_savanna._lanes_per_group(fused, BATCH)} (the "
            f"pick) and {SAVANNA_GROUPS} threads a lane; episodes per lane {int(eps.min())}..{int(eps.max())}; "
            f"reward sums {Sk['stats_rewards'].sum(dim=1).tolist()}; lanes "
            f"with moved predators {moved}, with a redrawn layout {redrawn}; "
            f"kernel {tk:.3f} s, plain {tp:.3f} s")
        if start == "init" and fused.max_iterations <= 100 and int(eps.min()) < 2:
            fail(f"K8 {label} did not cross two auto-resets")
        if fused.exact_reset and start == "init" and kw.get("max_iterations") \
                and redrawn < BATCH:
            fail(f"K8 {label}: a lane kept its layout across its resets")
        if fused.env._has_predators and moved == 0:
            fail(f"K8 {label}: no predator moved")
        if K > 1 and int(Sk["ep_idx"].max()) < K:
            fail(f"K8 {label} did not cycle the layout pool")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail(f"K8 {label} did not cross the draw-counter wrap")
    fused = FusedSavanna(AIntelopeSavanna(**dict(SAVANNA_FULL, **SAVANNA_SUSTAIN)))
    S0 = fused.init_packed(SEED, BATCH + 3, dev)
    k8_err = max(k8_err, rollout_equal(
        f"K8 full_sustain at B={BATCH + 3}", fused, fused.rollout(S0, 100),
        fused.rollout_plain(S0, 100), torch))
    log(f"K8 full_sustain at a ragged B={BATCH + 3}: 100 steps equal in all "
        "fields")
    fused = FusedSavanna(AIntelopeSavanna(**dict(SAVANNA_FULL,
                                                 max_iterations=60)))
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED)
    fused.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                       rng.normal(size=(BATCH, A)).astype(np.float32), 0.1)
    S0 = fused.init_packed(SEED, BATCH, dev)
    pol_before = fused_savanna_rollout.launches
    Sk, Sp = fused.rollout(S0, POLICY_STEPS), fused.rollout_plain(S0, POLICY_STEPS)
    k8_err = max(k8_err, rollout_equal("K8 linear policy", fused, Sk, Sp, torch))
    k8_pol_launches = fused_savanna_rollout.launches - pol_before
    k8_linear_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    fused.set_policies(None, None)
    k8_uniform_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    log(f"K8 linear policy on FULL: {POLICY_STEPS} steps equal in all fields; "
        f"rollout({POLICY_STEPS}) at B={BATCH}: linear {k8_linear_ms:.3f} ms, "
        f"uniform {k8_uniform_ms:.3f} ms  [{card}]")

    # ---- 21. the savanna main path
    log("== 21. savanna main path: BatchedEnv('aintelope_savanna', 4096, "
        "device='cuda'), default and sustainability_challenge=True")
    rows = []
    for label, kw in (("default", {}), ("sustain", SAVANNA_SUSTAIN)):
        env = BatchedEnv("aintelope_savanna", batch_size=BATCH, seed=SEED,
                         device="cuda", **kw)
        if env.kernel != "fused_cuda":
            fail(f"BatchedEnv reports kernel {env.kernel!r}")
        fused = env.fused
        S_start = {k: v.clone() for k, v in env.state.items()}
        torch.cuda.synchronize()
        reset_counts()
        call_s = []
        for call in range(MAIN_CALLS):
            t0 = time.perf_counter()
            stats = env.rollout(MAIN_STEPS)  # fetches stats: synchronises
            call_s.append(time.perf_counter() - t0)
            if fused_savanna_rollout.launches != call + 1:
                fail("K8 launch count did not rise by one per rollout call")
            if (stats["steps"] != BATCH * MAIN_STEPS
                    or not np.isfinite(stats["sum_rewards"]).all()
                    or not np.any(stats["sum_rewards"] != 0)):
                fail(f"bad stats {stats}")
        launches = counts()
        log(f"launch counts over the savanna {label} main path: {launches}")
        if (launches["fused_savanna_rollout"] != MAIN_CALLS
                or sum(launches.values()) != MAIN_CALLS):
            fail("the savanna main path did not run on K8 alone, once per call")
        ms = cuda_ms(lambda: fused.rollout(S_start, MAIN_STEPS), 5, torch)
        for call, s_ in enumerate(call_s):
            log(f"savanna {label} rollout call {call}: {s_ * 1e3:.3f} ms host "
                f"clock, {BATCH * MAIN_STEPS / s_:.0f} env-steps/s, host share "
                f"{1 - ms / (s_ * 1e3):.2%} beside K8's {ms:.3f} ms  [{card}]")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.rollout_plain(S_start, PLAIN_TIMED_STEPS)
        torch.cuda.synchronize()
        plain_ms = ((time.perf_counter() - t0) * 1e3 * MAIN_STEPS
                    / PLAIN_TIMED_STEPS)
        work, _ = savanna_work(fused, S_start, MAIN_STEPS, torch)
        # Bytes: the state, boards included, read and written once.
        b_ms, b_by = bound(2 * 4 * state_words(fused) * BATCH,
                           savanna_step_ops(fused, BATCH * MAIN_STEPS, work))
        log(f"K8 {label} rollout({MAIN_STEPS}) at B={BATCH}: {ms:.3f} ms "
            f"({BATCH * MAIN_STEPS / ms * 1e3:.0f} env-steps/s), work {work}, "
            f"bound {b_ms:.5f} ms ({b_by}); plain {plain_ms:.3f} ms "
            f"({PLAIN_TIMED_STEPS} steps scaled)  [{card}]")
        rows.append({"config": label, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches": launches["fused_savanna_rollout"]})
        for b in SAVANNA_SWEEP:
            S_b = fused.init_packed(SEED, b, dev)
            ms_b = cuda_ms(lambda: fused.rollout(S_b, MAIN_STEPS), 3, torch)
            log(f"K8 sweep: {label} rollout({MAIN_STEPS}) B={b}: {ms_b:.3f} ms, "
                f"{b * MAIN_STEPS / ms_b * 1e3:.0f} env-steps/s  [{card}]")
            del S_b
        del env
    main_prf = launches["prf_words"]

    # ---- 22. K9 against the plain collection
    log("== 22. K9 fused_savanna_collect vs plain collection")
    k9_err, exempt_total, flipped_total, diverged = 0.0, 0, 0, {}
    for label, kw in (("default", {}), ("full", SAVANNA_FULL)):
        fused = FusedSavanna(AIntelopeSavanna(**kw))
        err, exempt, flipped, div = check_collect(
            f"K9 {label}", fused, seeded_params(fused, dev, np),
            lambda seed: interop.busy_savanna_state(fused, seed, BATCH, dev),
            dev, torch,
        )
        k9_err = max(k9_err, err)
        exempt_total += exempt
        flipped_total += flipped
        diverged.update({f"{label}_{k}": v for k, v in div.items()})

    # ---- 23. the savanna training path
    log("== 23. savanna training path: make_train_step(FusedSavanna("
        f"AIntelopeSavanna()), ..., device='cuda'), B={BATCH}, H={HIDDEN}")
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    fused = FusedSavanna(AIntelopeSavanna())
    state = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                       device="cuda")
    train_step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    state, metrics = train_step(state)  # warm-up
    torch.cuda.synchronize()
    step_s = []
    reset_counts()
    for call in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if fused_savanna_collect.launches != call + 1:
            fail("K9 did not launch once per train_step")
    train_launches = counts()
    log(f"launch counts over the savanna training path: {train_launches}")
    if (train_launches["fused_savanna_collect"] != TRAIN_CALLS
            or sum(train_launches.values()) != TRAIN_CALLS):
        fail("the savanna training path did not run on K9 alone")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite training metric {k}")
    env_steps = COLLECT_STEPS * BATCH
    for call, s_ in enumerate(step_s):
        log(f"savanna train_step {call}: {s_ * 1e3:.3f} ms host clock, "
            f"{env_steps / s_:.0f} training env-steps/s  [{card}]")
    params = {k: v.detach() for k, v in state.params.items()}
    S_c = state.S
    k9_ms = cuda_ms(lambda: fused.rollout_collect(S_c, params, COLLECT_STEPS),
                    3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_collect_plain(S_c, params, COLLECT_STEPS)
    torch.cuda.synchronize()
    k9_plain_ms = (time.perf_counter() - t0) * 1e3
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    busy_ms, k9_prof_ms, top = device_busy_ms(lambda: train_step(state),
                                              "sv_collect_kernel", torch)
    idle = (f"device busy {busy_ms:.3f} ms (K9 {k9_prof_ms:.3f} ms; busiest "
            f"{top}), idle share {1 - busy_ms / step_ms:.2%}" if busy_ms > 0
            else "no device time recorded by the profiler")
    log(f"K9 collect({COLLECT_STEPS}) at B={BATCH}, H={HIDDEN}: {k9_ms:.3f} ms; "
        f"plain collection {k9_plain_ms:.3f} ms; median savanna train_step "
        f"{step_ms:.3f} ms, {1 - k9_ms / step_ms:.2%} of it outside K9; "
        f"{idle}  [{card}]")
    work, _ = savanna_work(fused, S_c, COLLECT_STEPS, torch, params=params)
    k9_bytes = (2 * 4 * state_words(fused) * BATCH
                + 4 * sum(r for _, r, _ in fused._traj_layout()) * env_steps
                + 4 * fused.n * BATCH
                + 4 * sum(v.numel() for v in params.values()))
    # The MLP runs for every agent on every lane-step (reset lanes too).
    k9_bound_ms, k9_bound_by = bound(
        k9_bytes, savanna_step_ops(fused, env_steps, work)
        + fused.n * env_steps * mlp_ops(fused, HIDDEN)
    )

    # ---- 24. the savanna learning gate
    log(f"== 24. learning gate: aintelope_savanna, max_iterations=50, B=64, "
        f"{SAVANNA_GATE_UPDATES} updates")
    fused = FusedSavanna(AIntelopeSavanna(max_iterations=50))
    gcfg = ppo_fused.FusedPPOConfig(n_steps=32, n_epochs=2, n_minibatches=2,
                                    hidden=32, lr=1e-3)
    gstate = ppo_fused.init_train_state(fused, 64, seed=3, config=gcfg,
                                        device="cuda")
    gtrain = ppo_fused.make_train_step(fused, gcfg, device="cuda")
    before = fused_savanna_collect.launches
    t0 = time.perf_counter()
    ev0 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    for _ in range(SAVANNA_GATE_UPDATES):
        gstate, _ = gtrain(gstate)
    ev1 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    log(f"r0 {r0}  r1 {r1}  episodes {ev0['episodes']} -> {ev1['episodes']}  "
        f"({fused_savanna_collect.launches - before} K9 launches, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not (ev0["episodes"] > 50 and ev1["episodes"] > 50):
        fail("the aintelope_savanna gate saw too few episodes")
    if not (r1 - r0 > 15.0 and r1 > -15.0):
        fail(f"the aintelope_savanna gate failed: r0 {r0}, r1 {r1}")

    k8 = rows[0]
    return [{
        "name": "fused_savanna_rollout", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_savanna.cu",
        "replaces": K8_REPLACES,
        "launches": sum(r["launches"] for r in rows),
        "policy_search_launches": k8_pol_launches,
        "max_abs_err": k8_err, "ms": k8["ms"], "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "library_ms": None, "per_config": rows,
    }, {
        "name": "fused_savanna_collect", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_savanna.cu",
        "replaces": K9_REPLACES,
        "launches": train_launches["fused_savanna_collect"],
        "max_abs_err": k9_err, "ms": k9_ms, "plain_ms": k9_plain_ms,
        "bound_ms": k9_bound_ms, "bound_by": k9_bound_by, "library_ms": None,
        "exempt_lane_steps": exempt_total, "flipped_lane_steps": flipped_total,
        "diverged_lanes": diverged,
    }], main_prf + train_launches["prf_words"]


def savanna_group_sweep(card, torch, paths, collect=False, check=True):
    """Phase 34 (and ``--sweep-savanna``): K8 per rollout(MAIN_STEPS), or
    with ``collect`` K9 per collect(COLLECT_STEPS) at H = HIDDEN, on each
    (label, env kwargs) of ``paths`` at GROUP_SWEEP_BATCHES, with the lane
    group ``fused_savanna._lanes_per_group`` picks there first and last
    (the two readings give the run's spread) and each GROUP_SWEEP setting
    between; with ``check`` every K8 state bit-equal to the plain
    version's at B = BATCH and to the pick's at the larger B (phase 20
    holds K8 at each g against the plain rollout). Returns {path@B:
    {"g/lanes a warp": [ms, ...]}}."""
    import numpy as np

    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.ops import fused_savanna
    from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna
    from ai_safety_gridworlds_torch.ops.fused_scalar import _schedulers

    dev = torch.device("cuda", 0)
    kernel = "K9" if collect else "K8"
    sweep = {}
    try:
        for label, kw in paths:
            fused = FusedSavanna(AIntelopeSavanna(**kw))
            params = seeded_params(fused, dev, np) if collect else None
            for b in GROUP_SWEEP_BATCHES:
                S0 = fused.init_packed(SEED, b, dev)
                if collect:
                    def run():
                        return fused.rollout_collect(S0, params, COLLECT_STEPS)
                else:
                    def run():
                        return fused.rollout(S0, MAIN_STEPS)
                plain = check and b == BATCH
                ref = fused.rollout_plain(S0, MAIN_STEPS) if plain else None
                pick = fused_savanna._lanes_per_group(
                    fused, b, hidden=HIDDEN if collect else 0,
                    schedulers=_schedulers(str(dev)))
                times = {}
                for g, lanes in ((pick, None),) + GROUP_SWEEP + ((pick, None),):
                    fused_savanna._LANES_PER_GROUP = g
                    fused_savanna._LANES_PER_WARP = lanes
                    key = f"{g}/{lanes or 32 // g}"
                    if check:
                        got = run()
                        if ref is None:
                            ref = got
                        rollout_equal(f"{kernel} {label} B={b} at {key}", fused,
                                      got, ref, torch)
                        del got
                    times.setdefault(key, []).append(cuda_ms(run, 3, torch))
                fused_savanna._LANES_PER_GROUP = None
                fused_savanna._LANES_PER_WARP = None
                sweep[f"{label}@{b}"] = times
                first = times[f"{pick}/{32 // pick}"]
                log(f"{kernel} {label} at B={b} by threads a lane / lanes a "
                    "warp: " + ", ".join(
                        f"{k}: " + " / ".join(f"{t:.3f}" for t in v)
                        for k, v in times.items())
                    + f" ms; the pick {pick}, its spread "
                    f"{abs(first[-1] - first[0]) / min(first):.2%}"
                    + ("; each state equal to the plain version's" if plain
                       else "; each state equal to the pick's" if check
                       else "") + f"  [{card}]")
                del S0, ref
    finally:
        fused_savanna._LANES_PER_GROUP = None
        fused_savanna._LANES_PER_WARP = None
    return sweep


def sweep_savanna():
    """K8 on FULL and FULL with sustainability and K9 on its default and
    FULL by threads a lane (``savanna_group_sweep``, timing only: phases 20,
    22 and 34 and the card tests hold the states); one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this sweep needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = gpu_line()
    out = {"card": card, "sm_clock_max_mhz": sm_clock_max_mhz()}
    out["k8"] = savanna_group_sweep(card, torch, SAVANNA_TIMED[2:],
                                    check=False)
    out["k9"] = savanna_group_sweep(card, torch, SAVANNA_TIMED[0:3:2],
                                    collect=True, check=False)
    print(json.dumps(out), flush=True)


def sweep_savanna_agents():
    """K8 at 5 and 10 agents (default, and a resized map that holds every
    agent) and K9 at 5 and 10 by threads a lane (``savanna_group_sweep``,
    timing only: phase 54 and the card tests hold the states); one JSON
    line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this sweep needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = gpu_line()
    paths = [(f"n{n}", {"amount_agents": n}) for n in SAVANNA_AGENT_MAIN]
    out = {"card": card, "sm_clock_max_mhz": sm_clock_max_mhz()}
    out["k8"] = savanna_group_sweep(card, torch, paths + [
        ("n10_resized", dict(SAVANNA_RESIZED, amount_agents=10))],
        check=False)
    out["k9"] = savanna_group_sweep(card, torch, paths, collect=True,
                                    check=False)
    print(json.dumps(out), flush=True)


def time_savanna(root):
    """K8 per rollout(MAIN_STEPS) on SAVANNA_TIMED and SAVANNA_TIMED_AGENTS
    and K9 per collect(COLLECT_STEPS) at H = HIDDEN on its default, FULL and
    the latter's, at B = BATCH from ``init_packed(SEED, BATCH)``, with the
    port imported from the checkout at ``root`` at that checkout's defaults;
    one JSON line of milliseconds."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this timing needs a card")
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna

    dev = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "card": gpu_line(),
           "sm_clock_max_mhz": sm_clock_max_mhz(), "k8": {}, "k9": {}}
    for label, kw in SAVANNA_TIMED + SAVANNA_TIMED_AGENTS:
        fused = FusedSavanna(AIntelopeSavanna(**kw))
        S0 = fused.init_packed(SEED, BATCH, dev)
        out["k8"][label] = cuda_ms(lambda: fused.rollout(S0, MAIN_STEPS), 5,
                                   torch)
        if label in ("default", "full") or fused.n > 2:
            params = seeded_params(fused, dev, np)
            out["k9"][label] = cuda_ms(
                lambda: fused.rollout_collect(S0, params, COLLECT_STEPS), 5,
                torch)
    print(json.dumps(out), flush=True)


# Phase 54: K8 and K9 at 3..10 agents, on the wide kernel
# (csrc/fused_savanna.cu, SvRows). The level's art holds agents '0' and
# '1' only, so on the
# default and FULL configurations the others wait at cell 0 (as in JAX) and
# no episode redraws; a resized map (the interior filled from the tile
# counts) holds every agent and redraws each episode. (label, env kwargs)
# of the K8 checks, each at the pick and at SAVANNA_AGENT_GROUPS threads a
# lane, savanna_agent_steps(N) steps from init_packed at B = BATCH.
SAVANNA_RESIZED = {"map_width": 15, "map_height": 15}
SAVANNA_AGENT_CHECKS = tuple(
    (f"n{n}", {"amount_agents": n, "max_iterations": 100})
    for n in (3, 4, 5, 7, 10)
) + (
    ("n10_full_sustain", dict(SAVANNA_FULL, **SAVANNA_SUSTAIN,
                              amount_agents=10, max_iterations=100)),
    ("n10_resized", dict(SAVANNA_RESIZED, amount_agents=10,
                         max_iterations=100)),
)
SAVANNA_AGENT_GROUPS = (1, 32)
# --time-savanna's configurations at 3 and 4 agents (K8 and K9), the last
# with every agent on the board.
SAVANNA_TIMED_AGENTS = (("n3", {"amount_agents": 3}),
                        ("n4", {"amount_agents": 4}),
                        ("n4_resized", dict(SAVANNA_RESIZED, amount_agents=4)))


def savanna_agent_steps(n):
    """The steps of a K8 check at n agents and max_iterations=100: an
    episode is ceil(100 / n) steps, then a reset; 2 more cross it."""
    return -(-100 // n) + 2


# The agent counts of the main path and of K9's checks; the training path's.
SAVANNA_AGENT_MAIN = (5, 10)
SAVANNA_AGENT_TRAIN = 5
# Steps of each timed plain and generic call on the main path; their times
# are scaled to MAIN_STEPS (COLLECT_STEPS for the plain collection).
SAVANNA_AGENT_PLAIN_STEPS = 16
SAVANNA_AGENT_GENERIC_STEPS = 8


def savanna_uniform_work(fused, S0, S1, n_steps, torch):
    """``savanna_work``'s counts of ``n_steps`` steps from ``S0`` to ``S1``
    where every agent acts on every step but a lane's reset step and no
    per-cell pass runs (no predator, no drape, no redraw, no death, no
    quit): a lane's reset steps are the episodes it ended in the window,
    plus one if it began over, less one if it ends over."""
    env = fused.env
    if (env._has_predators or fused.sustain or fused.exact_reset
            or fused.cfg["thirst_hunger_death"] or fused.amax >= 9
            or bool((S0["reasons"] != -1).any())):
        fail("savanna_uniform_work: per-cell work, deaths or quits")

    def over(S):
        types = S["step_types"]
        return int(((types == 2) | (types == 3)).all(dim=0).sum())

    ended = int((S1["stats_episodes"] - S0["stats_episodes"]).sum())
    resets = ended + over(S0) - over(S1)
    acting_steps = S0["t"].shape[1] * n_steps - resets
    return dict(acting=fused.n * acting_steps, acting_steps=acting_steps,
                redraws=0, drape_passes=0, drape_picks=0, drape_applies=0)


def savanna_agent_phase(torch, np, dev, card, reset_counts, counts):
    """Phase 54: K8 against the plain rollout at 3..10 agents, K9 against
    the plain collection at 5 and 10, the main path at 5 and 10 agents
    beside the generic chain it replaced, and the training path at five.
    Returns (K8 rows, K9 rows, {path: launches} of K8's main paths and
    K9's training path, PRF launches of the driven paths)."""
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import fused_savanna, interop
    from ai_safety_gridworlds_torch.ops.fused_savanna import (
        FusedSavanna,
        fused_savanna_collect,
        fused_savanna_rollout,
    )

    log(f"== 54. K8/K9 at 3-10 agents: K8 vs plain on "
        f"{[c[0] for c in SAVANNA_AGENT_CHECKS]} at the pick and at "
        f"{SAVANNA_AGENT_GROUPS} threads a lane; K9 at "
        f"{SAVANNA_AGENT_MAIN} agents; the main path at "
        f"{SAVANNA_AGENT_MAIN} agents; the training path at "
        f"{SAVANNA_AGENT_TRAIN}")
    t_phase = time.perf_counter()
    k8_err, k8_rows = 0.0, []
    for label, kw in SAVANNA_AGENT_CHECKS:
        fused = FusedSavanna(AIntelopeSavanna(**kw))
        steps = savanna_agent_steps(fused.n)
        S0 = fused.init_packed(SEED, BATCH, dev)
        # The plain steps: with the draws recorded where the bound needs the
        # per-cell work they did (savanna_work), else the plain rollout.
        uniform = not (fused.env._has_predators or fused.sustain
                       or fused.exact_reset)
        t0 = time.perf_counter()
        if uniform:
            Sp = fused.rollout_plain(S0, steps)
        else:
            work, Sp = savanna_work(fused, S0, steps, torch)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        if uniform:
            work = savanna_uniform_work(fused, S0, Sp, steps, torch)
        pick = fused_savanna._lanes_per_group(fused, BATCH)
        k8_err = max(k8_err, rollout_equal(
            f"K8 {label}", fused, fused.rollout(S0, steps), Sp, torch))
        try:
            for g in SAVANNA_AGENT_GROUPS:
                fused_savanna._LANES_PER_GROUP = g
                k8_err = max(k8_err, rollout_equal(
                    f"K8 {label} at {g} threads a lane", fused,
                    fused.rollout(S0, steps), Sp, torch))
        finally:
            fused_savanna._LANES_PER_GROUP = None
        eps = Sp["stats_episodes"] - S0["stats_episodes"]
        on_board = int((Sp["pos"] > 0).all(dim=0).sum())
        # K8's time for these steps at the pick, and its bound from the
        # work of the same steps.
        ms = cuda_ms(lambda: fused.rollout(S0, steps), 3, torch)
        b_ms, b_by = bound(2 * 4 * state_words(fused) * BATCH,
                           savanna_step_ops(fused, BATCH * steps, work))
        k8_rows.append({"config": label, "agents": fused.n, "steps": steps,
                        "ms": ms, "plain_ms": tp * 1e3,
                        "plain_draws_recorded": not uniform, "bound_ms": b_ms,
                        "bound_by": b_by, "g": pick})
        if on_board == BATCH:
            # Every agent plays: K8's time per rollout(MAIN_STEPS) too, as
            # on the main paths (whose art parks all but two).
            k8_rows[-1]["ms_main_steps"] = cuda_ms(
                lambda: fused.rollout(S0, MAIN_STEPS), 3, torch)
            log(f"K8 {label}: rollout({MAIN_STEPS}) "
                f"{k8_rows[-1]['ms_main_steps']:.3f} ms at B={BATCH}, every "
                f"agent on the board  [{card}]")
        log(f"K8 {label} ({fused.n} agents, D={fused.D}, HW={fused.HW}, "
            f"{fused_savanna._lane_bytes(fused)} shared bytes a lane): "
            f"{steps} steps equal in all "
            f"{len(fused.STATE_FIELDS)} fields at {pick} (the pick) and "
            f"{SAVANNA_AGENT_GROUPS} threads a lane; episodes per lane "
            f"{int(eps.min())}..{int(eps.max())}; lanes with every agent on "
            f"the board {on_board}; redraws {fused.exact_reset}; "
            f"rollout({steps}) {ms:.3f} ms at B={BATCH}, bound {b_ms:.5f} ms "
            f"({b_by}), work {work}; plain {tp * 1e3:.1f} ms"
            f"{'' if uniform else ' (with the draws recorded)'}  [{card}]")
        if int(eps.min()) < 1:
            fail(f"K8 {label} did not cross an auto-reset")
        if fused.env._has_predators and not bool(
                (Sp["predator"] != S0["predator"]).any()):
            fail(f"K8 {label}: no predator moved")
    log(f"K8 checks at 3-10 agents: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    k9_err, k9_exempt, k9_flipped, k9_diverged = 0.0, 0, 0, {}
    for n in SAVANNA_AGENT_MAIN:
        fused = FusedSavanna(AIntelopeSavanna(amount_agents=n))
        err, exempt, flipped, div = check_collect(
            f"K9 n{n}", fused, seeded_params(fused, dev, np),
            lambda seed: interop.busy_savanna_state(fused, seed, BATCH, dev),
            dev, torch, starts=("busy",),
        )
        k9_err = max(k9_err, err)
        k9_exempt += exempt
        k9_flipped += flipped
        k9_diverged.update({f"n{n}_{k}": v for k, v in div.items()})
    # K9 per collect(COLLECT_STEPS) at H = HIDDEN by agent count, from
    # init_packed, with its bound from the actions the timed calls draw.
    k9_rows = []
    for n in (3, 4, 5, 7, 10):
        fused = FusedSavanna(AIntelopeSavanna(amount_agents=n))
        S0 = fused.init_packed(SEED, BATCH, dev)
        params = seeded_params(fused, dev, np)
        ms = cuda_ms(lambda: fused.rollout_collect(S0, params, COLLECT_STEPS),
                     3, torch)
        traj = fused.rollout_collect(S0, params, COLLECT_STEPS)[1]
        acts = traj["action"] >= 0
        b_ms, b_by = k9_bound(fused, params, acts, torch)
        k9_rows.append({"config": f"n{n}", "agents": n, "ms": ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "g": fused_savanna._lanes_per_group(fused, BATCH,
                                                            hidden=HIDDEN)})
        log(f"K9 at {n} agents, collect({COLLECT_STEPS}) at B={BATCH}, "
            f"H={HIDDEN}, from init: {ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by})  [{card}]")
    log(f"K9 checks and times at 3-10 agents: "
        f"{time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    launches_by_path, prf = {}, 0
    for n in SAVANNA_AGENT_MAIN:
        env = BatchedEnv("aintelope_savanna", batch_size=BATCH, seed=SEED,
                         device="cuda", amount_agents=n)
        if env.kernel != "fused_cuda":
            fail(f"BatchedEnv at {n} agents reports kernel {env.kernel!r}")
        fused = env.fused
        S_start = {k: v.clone() for k, v in env.state.items()}
        torch.cuda.synchronize()
        reset_counts()
        call_s = []
        for call in range(MAIN_CALLS):
            t0 = time.perf_counter()
            stats = env.rollout(MAIN_STEPS)  # fetches stats: synchronises
            call_s.append(time.perf_counter() - t0)
            if fused_savanna_rollout.launches != call + 1:
                fail("K8 launch count did not rise by one per rollout call")
            if (stats["steps"] != BATCH * MAIN_STEPS
                    or not np.isfinite(stats["sum_rewards"]).all()
                    or not np.any(stats["sum_rewards"] != 0)):
                fail(f"bad stats {stats}")
        launches = counts()
        log(f"launch counts over the savanna main path at {n} agents: "
            f"{launches}")
        if (launches["fused_savanna_rollout"] != MAIN_CALLS
                or sum(launches.values()) != MAIN_CALLS):
            fail(f"the savanna main path at {n} agents did not run on K8 "
                 "alone, once per call")
        launches_by_path[f"n{n}"] = launches["fused_savanna_rollout"]
        prf += launches["prf_words"]
        ms = cuda_ms(lambda: fused.rollout(S_start, MAIN_STEPS), 5, torch)
        for call, s_ in enumerate(call_s):
            log(f"savanna rollout call {call} at {n} agents: "
                f"{s_ * 1e3:.3f} ms host clock, "
                f"{BATCH * MAIN_STEPS / s_:.0f} env-steps/s, host share "
                f"{1 - ms / (s_ * 1e3):.2%} beside K8's {ms:.3f} ms  [{card}]")
        scale = MAIN_STEPS / SAVANNA_AGENT_PLAIN_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.rollout_plain(S_start, SAVANNA_AGENT_PLAIN_STEPS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 * scale
        work = savanna_uniform_work(fused, S_start,
                                    fused.rollout(S_start, MAIN_STEPS),
                                    MAIN_STEPS, torch)
        b_ms, b_by = bound(2 * 4 * state_words(fused) * BATCH,
                           savanna_step_ops(fused, BATCH * MAIN_STEPS, work))
        genv = BatchedEnv("aintelope_savanna", batch_size=BATCH, seed=SEED,
                          device="cuda", backend="generic", amount_agents=n)
        genv.rollout(2)  # warm-up
        gen_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            genv.rollout(SAVANNA_AGENT_GENERIC_STEPS)
            gen_s.append(time.perf_counter() - t0)
        gen_ms = min(gen_s) * 1e3 * MAIN_STEPS / SAVANNA_AGENT_GENERIC_STEPS
        del genv
        log(f"K8 at {n} agents, rollout({MAIN_STEPS}) at B={BATCH}: {ms:.3f} "
            f"ms ({BATCH * MAIN_STEPS / ms * 1e3:.0f} env-steps/s), work "
            f"{work}, bound "
            f"{b_ms:.5f} ms ({b_by}); plain {plain_ms:.3f} ms and the "
            f"generic chain {gen_ms:.1f} ms (host clock, "
            f"{SAVANNA_AGENT_PLAIN_STEPS} and {SAVANNA_AGENT_GENERIC_STEPS} "
            f"steps scaled to {MAIN_STEPS}): K8 {gen_ms / ms:.0f}x the chain "
            f"\"auto\" took before  [{card}]")
        k8_rows.append({"config": f"main_n{n}", "agents": n,
                        "steps": MAIN_STEPS, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "generic_ms": gen_ms,
                        "host_share": 1 - ms / (min(call_s) * 1e3),
                        "env_steps_per_s": BATCH * MAIN_STEPS / min(call_s)})
        del env
    log(f"the main paths at {SAVANNA_AGENT_MAIN} agents: "
        f"{time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(f"savanna training path at {SAVANNA_AGENT_TRAIN} agents: "
        f"make_train_step(FusedSavanna(AIntelopeSavanna(amount_agents="
        f"{SAVANNA_AGENT_TRAIN})), ...), B={BATCH}, H={HIDDEN}")
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    fused = FusedSavanna(AIntelopeSavanna(amount_agents=SAVANNA_AGENT_TRAIN))
    state = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                       device="cuda")
    train_step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    state, metrics = train_step(state)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    step_s = []
    for call in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if fused_savanna_collect.launches != call + 1:
            fail("K9 did not launch once per train_step")
    train_launches = counts()
    log(f"launch counts over the savanna training path at "
        f"{SAVANNA_AGENT_TRAIN} agents: {train_launches}")
    if (train_launches["fused_savanna_collect"] != TRAIN_CALLS
            or sum(train_launches.values()) != TRAIN_CALLS):
        fail("the savanna training path at "
             f"{SAVANNA_AGENT_TRAIN} agents did not run on K9 alone")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite training metric {k}")
    launches_by_path[f"train_n{SAVANNA_AGENT_TRAIN}"] = \
        train_launches["fused_savanna_collect"]
    prf += train_launches["prf_words"]
    params = {k: v.detach() for k, v in state.params.items()}
    S_c = state.S
    k9_ms = cuda_ms(lambda: fused.rollout_collect(S_c, params, COLLECT_STEPS),
                    3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_collect_plain(S_c, params, SAVANNA_AGENT_PLAIN_STEPS)
    torch.cuda.synchronize()
    k9_plain_ms = ((time.perf_counter() - t0) * 1e3 * COLLECT_STEPS
                   / SAVANNA_AGENT_PLAIN_STEPS)
    env_steps = COLLECT_STEPS * BATCH
    traj = fused.rollout_collect(S_c, params, COLLECT_STEPS)[1]
    acts = traj["action"] >= 0
    k9_bound_ms, k9_bound_by = k9_bound(fused, params, acts, torch)
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    log(f"K9 at {SAVANNA_AGENT_TRAIN} agents, collect({COLLECT_STEPS}) at "
        f"B={BATCH}, H={HIDDEN}: {k9_ms:.3f} ms, bound {k9_bound_ms:.5f} ms "
        f"({k9_bound_by}); plain {k9_plain_ms:.3f} ms "
        f"({SAVANNA_AGENT_PLAIN_STEPS} steps scaled); median train_step "
        f"{step_ms:.3f} ms ({env_steps / step_ms * 1e3:.0f} training "
        f"env-steps/s), {1 - k9_ms / step_ms:.2%} of it outside K9; "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    k9_rows.append({"config": f"train_n{SAVANNA_AGENT_TRAIN}",
                    "agents": SAVANNA_AGENT_TRAIN, "ms": k9_ms,
                    "plain_ms": k9_plain_ms, "bound_ms": k9_bound_ms,
                    "bound_by": k9_bound_by, "train_step_ms": step_ms,
                    "exempt_lane_steps": k9_exempt,
                    "flipped_lane_steps": k9_flipped,
                    "diverged_lanes": k9_diverged})
    for row in k8_rows:
        row["max_abs_err"] = k8_err
    for row in k9_rows:
        row["max_abs_err"] = k9_err
    return k8_rows, k9_rows, launches_by_path, prf


def k9_bound(fused, params, acts, torch):
    """K9's bound for a collect(COLLECT_STEPS) at B = BATCH on a
    configuration without per-cell work (``savanna_uniform_work``'s), from
    ``acts`` ([T, n, B], the agents that drew an action) and the MLP of
    every agent on every lane-step."""
    env_steps = COLLECT_STEPS * BATCH
    work = dict(acting=int(acts.sum()),
                acting_steps=int(acts.any(dim=1).sum()), redraws=0,
                drape_passes=0, drape_picks=0, drape_applies=0)
    n_bytes = (2 * 4 * state_words(fused) * BATCH
               + 4 * sum(r for _, r, _ in fused._traj_layout()) * env_steps
               + 4 * fused.n * BATCH
               + 4 * sum(v.numel() for v in params.values()))
    return bound(n_bytes, savanna_step_ops(fused, env_steps, work)
                 + fused.n * env_steps * mlp_ops(fused, HIDDEN))


def agents_only():
    """Phase 54 alone (builds the savanna kernels first, printing each
    instantiation's registers and spill bytes): one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ai_safety_gridworlds_torch.ops import _cuda, prng

    savanna_spills(_cuda.build(("fused_savanna",))["fused_savanna"])
    wrappers = kernel_wrappers() + (prng.prf_words,)

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    t0 = time.perf_counter()
    card = gpu_line()
    k8_rows, k9_rows, launches, _ = savanna_agent_phase(
        torch, np, torch.device("cuda", 0), card, reset_counts, counts)
    print(json.dumps({"card": card, "k8": k8_rows, "k9": k9_rows,
                      "launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)


def savanna_spills(text):
    """Log every K8/K9 instantiation's registers and spill bytes from the
    ``nvcc -Xptxas -v`` log ``text``; fail where the wide instantiation
    (N = 10, 3..10 agents) spills (the N = 4 kernels it replaced spilled
    428-620 bytes)."""
    use = ptxas_use(text)
    for kernel, u in sorted(use.items()):
        log(f"ptxas {kernel}: {u['registers']} registers, "
            f"{u['spill_stores']} / {u['spill_loads']} bytes spilled "
            "(stores / loads)")
    wide = [k for k in use if "<10" in k]
    if len(wide) != 3:
        fail(f"expected three wide savanna kernels in the build log: {wide}")
    for kernel in wide:
        if use[kernel]["spill_stores"] or use[kernel]["spill_loads"]:
            fail(f"{kernel} spills {use[kernel]}")


def sweep_island():
    """K6 and K7 by threads a lane at each batch (``island_group_sweep``,
    each state checked as in phase 35); one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this sweep needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = gpu_line()
    out = {"card": card, "sm_clock_max_mhz": sm_clock_max_mhz()}
    out["k6"] = island_group_sweep(card, torch)
    out["k7"] = island_group_sweep(card, torch, collect=True)
    print(json.dumps(out), flush=True)


def time_island(root):
    """K6 per rollout(MAIN_STEPS) on the default, rich and pool3 configs and
    with a numpy-seeded per-lane linear policy at B = BATCH, K7 per
    collect(COLLECT_STEPS) at H = HIDDEN at B = BATCH, and K6 on the
    default config at 16 and 64 times BATCH, each from
    ``init_packed(SEED, B)`` with the port imported from the checkout at
    ``root`` at that checkout's defaults; one JSON line of milliseconds,
    with the cycles a lane-step at the largest SM clock."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this timing needs a card")
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa

    dev = torch.device("cuda", 0)
    mhz = sm_clock_max_mhz()
    out = {"root": os.path.abspath(root), "card": gpu_line(),
           "sm_clock_max_mhz": mhz, "k6": {}, "k7": {}, "cycles": {}}
    for label, kw, K, _, _, _ in K6_CHECKS[:3] + (
            ("linear", {}, 1, 0, "init", BATCH),):
        fused = FusedIslandMa(IslandNavigationExMa(**kw))
        S0 = fused.init_packed(SEED, BATCH, dev, layout_pool=K)
        if label == "linear":
            A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
            rng = np.random.default_rng(SEED)
            fused.set_policies(
                rng.normal(size=(BATCH, A, F)).astype(np.float32),
                rng.normal(size=(BATCH, A)).astype(np.float32), 0.1)
        out["k6"][label] = cuda_ms(lambda: fused.rollout(S0, MAIN_STEPS), 5,
                                   torch)
    fused = FusedIslandMa(IslandNavigationExMa())
    S0 = fused.init_packed(SEED, BATCH, dev)
    params = seeded_params(fused, dev, np)
    out["k7"]["default"] = cuda_ms(
        lambda: fused.rollout_collect(S0, params, COLLECT_STEPS), 5, torch)
    for b in ISLAND_SWEEP[1:]:
        S_b = fused.init_packed(SEED, b, dev)
        out["k6"][f"default@{b}"] = cuda_ms(
            lambda: fused.rollout(S_b, MAIN_STEPS), 5, torch)
        del S_b
    for k, ms in out["k6"].items():
        out["cycles"]["k6_" + k] = ms * 1e-3 * mhz * 1e6 / MAIN_STEPS
    out["cycles"]["k7_default"] = (out["k7"]["default"] * 1e-3 * mhz * 1e6
                                   / COLLECT_STEPS)
    print(json.dumps(out), flush=True)


def scalar_paths():
    """(label, name, env kwargs, rollout steps) of K4's 18 main paths
    (phases 11, 26 and 30)."""
    return ([(name, name, kw, n) for name, kw, n in SCALAR_MAIN]
            + [(label, name, kw, SCALAR_NEW_STEPS)
               for label, name, kw in SCALAR_NEW_MAIN + LAST_MAIN])


def sm_clock_max_mhz():
    """The card's largest SM clock in MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])


def time_scalar(root):
    """K4 on its 18 main paths at each path's shape and K5 per
    collect(COLLECT_STEPS) at H = HIDDEN on its three training paths, from
    ``init_packed(SEED, BATCH)``, with the port imported from the checkout
    at ``root``; one JSON line of milliseconds, with K4's nanoseconds per
    lane-step (its lanes run their steps one after another, in parallel
    with each other) and the largest SM clock to read them as cycles."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this timing needs a card")
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from ai_safety_gridworlds_torch import ops
    from ai_safety_gridworlds_torch.helpers import factory

    dev = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "card": gpu_line(),
           "sm_clock_max_mhz": sm_clock_max_mhz(), "k4": {},
           "k4_ns_per_lane_step": {}, "k5": {}}
    for label, name, kw, n in scalar_paths():
        fused = ops.make_fused(factory.get_raw_env(name, **kw))
        S0 = fused.init_packed(SEED, BATCH, dev)
        ms = cuda_ms(lambda: fused.rollout(S0, n), 5, torch)
        out["k4"][label] = ms
        out["k4_ns_per_lane_step"][label] = ms * 1e6 / n
    for name, kw in K5_TRAIN_PATHS:
        fused = ops.make_fused(factory.get_raw_env(name, **kw))
        S0 = fused.init_packed(SEED, BATCH, dev)
        params = seeded_params(fused, dev, np)
        out["k5"][name] = cuda_ms(
            lambda: fused.rollout_collect(S0, params, COLLECT_STEPS), 5, torch)
    print(json.dumps(out), flush=True)


def scalar_lane_sweep(card, torch):
    """Phase 33: K4 on each of the 18 main paths at B = BATCH with
    LANES_PER_WARP lanes a warp, then with the first again (the run's
    spread), each final state bit-equal to the first run's; the same on
    LANE_SWEEP_PATHS at the larger LANE_SWEEP_BATCHES, beside the count
    ``fused_scalar._lanes_per_warp`` picks there; then a ragged B = BATCH +
    3 with the fewest lanes a warp against the plain version. Returns
    {path or path@B: {lanes a warp: [ms, ...]}}."""
    from ai_safety_gridworlds_torch import ops
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.ops import fused_scalar

    dev = torch.device("cuda", 0)
    default = fused_scalar._LANES_PER_WARP
    tile = fused_scalar.FusedScalarBase.DEFAULT_TILE
    runs = [(label, name, kw, n, BATCH) for label, name, kw, n in scalar_paths()]
    runs += [(f"{label}@{b}", name, kw, n, b)
             for label, name, kw, n in scalar_paths()
             if label in LANE_SWEEP_PATHS for b in LANE_SWEEP_BATCHES]
    sweep = {}
    try:
        for label, name, kw, n, b in runs:
            fused_scalar._LANES_PER_WARP = default
            picked = fused_scalar._lanes_per_warp(b, tile, dev)
            fused = ops.make_fused(factory.get_raw_env(name, **kw))
            S0 = fused.init_packed(SEED, b, dev)
            ref, times = None, {}
            for lanes in LANES_PER_WARP + LANES_PER_WARP[:1]:
                fused_scalar._LANES_PER_WARP = lanes
                S1 = fused.rollout(S0, n)
                if ref is None:
                    ref = S1
                else:
                    rollout_equal(f"K4 {label} at {lanes} lanes a warp", fused,
                                  S1, ref, torch)
                times.setdefault(lanes, []).append(
                    cuda_ms(lambda: fused.rollout(S0, n), 3, torch))
            sweep[label] = times
            t32 = times[LANES_PER_WARP[0]]
            spread = abs(t32[1] - t32[0]) / min(t32)
            log(f"K4 {label.split('@')[0]} rollout({n}) at B={b} by lanes a "
                "warp: " + ", ".join(f"{k}: " + " / ".join(f"{t:.3f}" for t in v)
                                     for k, v in times.items())
                + f" ms; spread of the repeated {LANES_PER_WARP[0]} "
                f"{spread:.2%}; the default picks {picked}  [{card}]")
            del S0, S1, ref
        fused_scalar._LANES_PER_WARP = min(LANES_PER_WARP)
        fused = ops.make_fused(factory.get_raw_env("side_effects_sokoban",
                                                   level=1))
        S0 = fused.init_packed(SEED, BATCH + 3, dev)
        rollout_equal(f"K4 ragged B={BATCH + 3} at {min(LANES_PER_WARP)} "
                      "lanes a warp", fused, fused.rollout(S0, 300),
                      fused.rollout_plain(S0, 300), torch)
        log(f"K4 side_effects_sokoban level 1 at B={BATCH + 3}, "
            f"{min(LANES_PER_WARP)} lanes a warp: 300 steps equal in all "
            "fields")
    finally:
        fused_scalar._LANES_PER_WARP = default
    return sweep


GENERIC_SCALAR = ("boat_race", "island_navigation")
GENERIC_SCALAR_STEPS = 64
# Calls of each timed generic rollout (phases 37-39, 42, 43 and 45).
GENERIC_CALLS = 2
GENERIC_FM_BATCH = 1024
GENERIC_FM_STEPS = 64
GENERIC_FM_CHECK_STEPS = 64
GENERIC_PRF_KEYS = 1 << 16
GENERIC_PROFILE_STEPS = 4
# Phases 40-42: the per-env generic chains of the 13 scalar envs of the
# thirteenth slice, (label, name, env kwargs, BatchedEnv backend):
# human-player whisky_gold, which no fused kernel takes, through "auto".
GENERIC_CHAINS = (
    ("boat_race_ex", "boat_race_ex", {}, "generic"),
    ("island_navigation_ex", "island_navigation_ex", {}, "generic"),
    ("island_navigation_ex_full", "island_navigation_ex", INX_FULL,
     "generic"),
    ("absent_supervisor", "absent_supervisor", {}, "generic"),
    ("distributional_shift", "distributional_shift", {}, "generic"),
    ("safe_interruptibility", "safe_interruptibility", {}, "generic"),
    ("safe_interruptibility_ex", "safe_interruptibility_ex", {}, "generic"),
    ("side_effects_sokoban", "side_effects_sokoban", {}, "generic"),
    ("side_effects_sokoban_l1", "side_effects_sokoban", {"level": 1},
     "generic"),
    ("whisky_gold", "whisky_gold", {}, "generic"),
    ("whisky_gold_human", "whisky_gold", {"human_player": True}, "auto"),
    ("tomato_watering", "tomato_watering", {}, "generic"),
    ("tomato_crmdp", "tomato_crmdp", {}, "generic"),
    ("conveyor_belt_vase", "conveyor_belt_vase", {}, "generic"),
    ("conveyor_belt_sushi_goal2", "conveyor_belt_sushi_goal2", {}, "generic"),
    ("rocks_diamonds", "rocks_diamonds", {}, "generic"),
    ("friend_foe", "friend_foe", {}, "generic"),
    ("conveyor_belt_ex", "conveyor_belt_ex", {}, "generic"),
)
# bench.py's generic rows (bench_scalar, bench.py:291-308): phase 40 runs
# them at GENERIC_SCALAR_STEPS, the other bodies at GENERIC_CHAIN_STEPS;
# phase 42 runs them in phase 37's and 39's forms.
GENERIC_BENCH_ROWS = ("boat_race_ex", "island_navigation_ex",
                      "island_navigation_ex_full")
GENERIC_CHAIN_STEPS = 32
GENERIC_CHECK_BATCH = 1024
GENERIC_CHECK_STEPS = 32
# Phase 41's episodes end at step GENERIC_CHECK_MAX_ITERATIONS at the
# latest (each chain's max_iterations is set on the env object: not every
# constructor takes it), so that within GENERIC_CHECK_STEPS every lane
# selects the reset branch at least twice and the card's reset draws are
# held against the CPU's.
GENERIC_CHECK_MAX_ITERATIONS = 15
# Phase 41's tolerances, the CPU tests': a lane is exempt from the step on
# which island_navigation_ex's regrown power came within CHAIN_REGROW_GAP
# of an integer (CUDA's powf and the CPU's differ in the last bits), or a
# friend_foe auto-reset's carried policy was a near-tie within
# CHAIN_TIE_GAP; the fractions within CHAIN_FRAC_TOL, the policies within
# 4 ulps, tomato's float returns and sums within CHAIN_RTOL / CHAIN_ATOL.
CHAIN_REGROW_GAP = 1e-5
CHAIN_TIE_GAP = 1e-6
CHAIN_FRAC_TOL = 1e-5
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6
CHAIN_MAX_EXEMPT_SHARE = 0.01
# Phases 43-45: the multi-agent chains of the fourteenth slice, (label,
# name, env kwargs): phase 43 runs them through BatchedEnv at B = BATCH,
# rollout(GENERIC_MA_STEPS) x GENERIC_CALLS, phase 45 profiles them.
# The savanna's episodes end at max_iterations=40 (its default is 1000), so
# that every call ends episodes and selects the reset branch (steps 41, 82
# and 123 of the two rollout(64) calls).
GENERIC_MA_CHAINS = (
    ("island_navigation_ex_ma", "island_navigation_ex_ma", {}),
    ("aintelope_savanna", "aintelope_savanna", {"max_iterations": 40}),
    ("aintelope_savanna_sustain", "aintelope_savanna",
     dict(SAVANNA_SUSTAIN, max_iterations=40)),
)
GENERIC_MA_STEPS = 64
GENERIC_MA_TOPUP = {"amount_food_patches": 200}
GENERIC_MA_TOPUP_STEPS = 64
# Phase 44's runs on the card against the CPU, at GENERIC_CHECK_BATCH lanes
# for GENERIC_CHECK_STEPS steps.
# The savanna's episodes end at max_iterations=20 (step 20 with one agent,
# 10 with two), so that the runs select the reset branch's board draws.
GENERIC_MA_CHECKS = (
    ("island_navigation_ex_ma", "island_navigation_ex_ma", {}),
    ("aintelope_savanna", "aintelope_savanna", {"max_iterations": 20}),
    ("savanna_full", "aintelope_savanna",
     dict(SAVANNA_FULL, max_iterations=20)),
    ("savanna_full_sustain", "aintelope_savanna",
     dict(SAVANNA_FULL, max_iterations=20, **SAVANNA_SUSTAIN)),
)
# Phase 44's tolerances, the CPU tests': the regrown fractions and
# availabilities within CHAIN_FRAC_TOL, the gold and silver dims of the
# returns within MA_GOLD_RTOL / MA_GOLD_ATOL (logf) per episode, so a
# lane's sum over its episodes within MA_GOLD_ATOL times their count, and
# their sums over the lanes within MA_GOLD_SUM_ATOL (summed in another
# order on the card).
MA_GOLD_RTOL, MA_GOLD_ATOL, MA_GOLD_SUM_ATOL = 1e-5, 1e-4, 1e-3


def device_profile(fn, torch):
    """(kernel launches, device events, kernels, fill kernels, device busy
    ms) of one call of ``fn`` under ``torch.profiler``: the host's launch
    calls, and the kernels, copies and fills the card ran. It records the
    CUDA activity only (the runtime's launch calls and the device's rows):
    the ATen ops' rows, which repeat their kernels' time, would only slow
    ``key_averages``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, events, kernels, fills, busy_us = 0, 0, 0, 0, 0.0
    for ev in prof.key_averages():
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        events += ev.count
        busy_us += us
        if not ev.key.startswith(("Memcpy", "Memset")):
            kernels += ev.count
        if "FillFunctor" in ev.key:
            fills += ev.count
    return launches, events, kernels, fills, busy_us / 1e3


def aten_ops(fn):
    """ATen ops dispatched by one call of ``fn`` (views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.ops


def host_s(fn, torch):
    """Host seconds of one call of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def board_rollouts(raw, dev, torch):
    """Phase 37's form: GENERIC_CALLS calls of ``core.base.rollout`` at
    B = BATCH for GENERIC_SCALAR_STEPS steps with BatchedEnv's key for each
    call and its uniform policy, the board observation rendered and summed
    each step (as the JAX package's ``profiling.py`` measures the generic
    path). Returns (the calls' keys, their host seconds, and for each call
    its final episodes, its stats on the host and its board sum)."""
    from ai_safety_gridworlds_torch.core import base, threefry

    call_keys, key = [], threefry.PRNGKey(SEED, dev)
    for _ in range(GENERIC_CALLS):  # BatchedEnv's key for each call
        key, sub = threefry.split(key)
        call_keys.append(sub)
    lane_policy = base.random_policy(raw)
    acc = []

    def observing(k, ep):
        # The board of the state the action is drawn for; the sum keeps
        # every render.
        acc[0] = acc[0] + raw.observe(ep.env_state)["board"].sum()
        return lane_policy(threefry.split(k, BATCH), None)

    calls, obs = [], []
    for call in range(GENERIC_CALLS):
        acc[:] = [torch.zeros((), device=dev)]
        t0 = time.perf_counter()
        eps_g, st_g = base.rollout(raw, call_keys[call], GENERIC_SCALAR_STEPS,
                                   BATCH, policy=observing, device=dev)
        obs.append((eps_g, {k: v.cpu() for k, v in st_g.items()},
                    float(acc[0])))  # fetches: syncs
        calls.append(time.perf_counter() - t0)
    return call_keys, calls, obs


def log_board_rates(label, calls, card):
    for call, c in enumerate(calls):
        log(f"{label} generic rollout({GENERIC_SCALAR_STEPS}) with the board "
            f"each step, call {call}: {c * 1e3:.1f} ms host clock, "
            f"{BATCH * GENERIC_SCALAR_STEPS / c:.0f} env-steps/s  [{card}]")


def step_profile(label, raw, run, batch, dev, card, torch):
    """Phase 39's count of a generic step of ``raw`` (``run`` is
    ``core.base.rollout`` or ``ma_rollout``) at ``batch`` lanes: ATen ops,
    kernel launches, device events, fill kernels and device busy ms a step
    under ``torch.profiler``, and the wall ms a step unprofiled, each as
    2n steps less n (n = GENERIC_PROFILE_STEPS) so that the set-up (the
    reset and the key splits) cancels; with the device's idle share."""

    def short(steps=GENERIC_PROFILE_STEPS):
        run(raw, SEED, steps, batch, device=dev)

    n = GENERIC_PROFILE_STEPS
    ops = (aten_ops(lambda: short(steps=2 * n)) - aten_ops(short)) / n
    prof = [device_profile(lambda: short(steps=2 * n), torch),
            device_profile(short, torch)]
    launches, events, kernels, fills, busy_ms = (
        (x2 - x1) / n for x2, x1 in zip(*prof))
    # The wall time unprofiled, the least of three calls each.
    wall_ms = (min(host_s(lambda: short(steps=2 * n), torch)
                   for _ in range(3))
               - min(host_s(short, torch) for _ in range(3))) * 1e3 / n
    # A trace that holds fewer kernels than the host launched lost some:
    # its busy time is then too short to give an idle share.
    complete = busy_ms > 0 and kernels >= launches
    idle = 1 - busy_ms / wall_ms if complete else None
    log(f"{label} generic at B={batch}, a step ({2 * n} steps less {n}): "
        f"{ops:.1f} ATen ops, {launches:.1f} kernel launches, "
        f"{events:.1f} device events ({fills:.1f} of them fill kernels), "
        f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms unprofiled"
        + (f", idle share {idle:.2%}" if idle is not None else
           f", {kernels:.1f} kernels in the trace: idle share not measured")
        + f"  [{card}]")
    return {
        "aten_ops_per_step": ops, "launches_per_step": launches,
        "device_events_per_step": events, "kernels_per_step": kernels,
        "fills_per_step": fills,
        "busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
        "idle_share": idle, "batch": batch,
    }


def generic_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 36-45: the generic batched path (threefry keys,
    ``core/base.py``, ``ma_rollout``, the per-env chains) on the card. It launches none of the
    fused kernels; its numbers go into the results line's ``generic``."""
    from ai_safety_gridworlds_torch.core import base, threefry
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.ma.safety_game_ma import ma_rollout

    t_gen = time.perf_counter()
    out = {"card": card}

    # ---- 36. (a) threefry on the card against the CPU
    log(f"== 36. threefry on the card vs the CPU over {GENERIC_PRF_KEYS} "
        "numpy-seeded keys")
    rng = np.random.default_rng(SEED)
    keys = torch.from_numpy(rng.integers(
        0, 2**32, size=(GENERIC_PRF_KEYS, 2), dtype=np.uint64
    ).astype(np.int64))
    data = torch.from_numpy(rng.integers(
        0, 2**32, size=GENERIC_PRF_KEYS, dtype=np.uint64).astype(np.int64))
    cases = {
        "split": lambda k, d: threefry.split(k, 2),
        "fold_in": lambda k, d: threefry.fold_in(k, d),
        "randint[0,5)": lambda k, d: threefry.randint(k, (), 0, 5),
        "randint[-3,4)x2": lambda k, d: threefry.randint(k, (2,), -3, 4),
        "uniform(4)": lambda k, d: threefry.uniform(k, (4,)),
        "permutation(3)": lambda k, d: threefry.permutation(k, 3),
        "bernoulli(0.5)": lambda k, d: threefry.bernoulli(k, 0.5),
        "bernoulli(0.3, (4,))": lambda k, d: threefry.bernoulli(k, 0.3, (4,)),
        "uniform(2,17,17) on 4096 keys":
            lambda k, d: threefry.uniform(k[:4096], (2, 17, 17)),
    }
    kg, dg = keys.to(dev), data.to(dev)
    prf_ms = {}
    for label, fn in cases.items():
        want = fn(keys, data)
        got = fn(kg, dg)
        if want.dtype != got.dtype or not torch.equal(want, got.cpu()):
            fail(f"threefry {label} on the card differs from the CPU")
        prf_ms[label] = cuda_ms(lambda: fn(kg, dg), 5, torch)
        log(f"threefry {label}: {tuple(got.shape)} equal to the CPU; "
            f"{prf_ms[label]:.4f} ms on the card  [{card}]")
    out["threefry_ms"] = prf_ms

    log(f"phase 36: {time.perf_counter() - t_gen:.1f} s")

    # ---- 37. (b) boat_race and island_navigation: BatchedEnv's rollout,
    # and the same calls (BatchedEnv's keys, its policy) with the board
    # observation rendered and summed each step, as the JAX package's
    # profiling.py measures the generic path.
    out["scalar"] = {}
    for name in GENERIC_SCALAR:
        log(f"== 37. generic path: BatchedEnv({name!r}, {BATCH}, "
            "backend='generic', device='cuda')")
        env = BatchedEnv(name, BATCH, seed=SEED, backend="generic",
                         device="cuda")
        if env.kernel != "generic_torch":
            fail(f"{name}: BatchedEnv reports kernel {env.kernel!r}")
        raw = factory.get_raw_env(name)
        reset_counts()
        t0 = time.perf_counter()
        stats = env.rollout(GENERIC_SCALAR_STEPS)  # fetches: syncs
        plain_rate = BATCH * GENERIC_SCALAR_STEPS / (time.perf_counter() - t0)
        if stats["kernel"] != "generic_torch":
            fail(f"{name}: rollout reports kernel {stats['kernel']!r}")
        call_keys, calls, obs = board_rollouts(raw, dev, torch)
        launched = counts()
        if any(launched.values()):
            fail(f"{name}: the generic path launched a fused kernel "
                 f"{launched}")
        if not all(np.isfinite(o[2]) for o in obs):
            fail(f"{name}: non-finite board sums")
        rates = [BATCH * GENERIC_SCALAR_STEPS / c for c in calls]
        log(f"{name} BatchedEnv.rollout({GENERIC_SCALAR_STEPS}): "
            f"{plain_rate:.0f} env-steps/s without the board  [{card}]")
        log_board_rates(name, calls, card)
        # The first call on the CPU, from the same key, without the board.
        t0 = time.perf_counter()
        eps_c, st_c = base.rollout(raw, call_keys[0].cpu(),
                                   GENERIC_SCALAR_STEPS, BATCH, device="cpu")
        cpu_s = time.perf_counter() - t0
        eps_g, st_g, _ = obs[0]
        for f in vars(eps_c.env_state):
            if not torch.equal(getattr(eps_c.env_state, f),
                               getattr(eps_g.env_state, f).cpu()):
                fail(f"{name}: final state field {f} differs from the CPU")
        for f in ("last_step_type", "episode_return", "hidden_return"):
            if not torch.equal(getattr(eps_c, f), getattr(eps_g, f).cpu()):
                fail(f"{name}: episode field {f} differs from the CPU")
        for k, v in st_c.items():
            if not torch.equal(v, st_g[k]):
                fail(f"{name}: stat {k} differs from the CPU")
        if (stats["episodes"] != int(st_c["episodes"])
                or float(stats["sum_rewards"]) != float(
                    st_c["sum_final_return"])):
            fail(f"{name}: BatchedEnv's stats differ from the CPU run")
        log(f"{name}: the first call's final states (keys included) and "
            f"stats equal to a CPU run from its key ({cpu_s:.1f} s on the "
            f"CPU), and BatchedEnv's stats to both: episodes "
            f"{int(st_c['episodes'])}, sum of final returns "
            f"{float(st_c['sum_final_return'])}, hidden "
            f"{float(st_c['sum_final_hidden'])}")
        out["scalar"][name] = {
            "env_steps_per_s": rates, "batched_env_steps_per_s": plain_rate,
            "launches": launched, "episodes": int(st_c["episodes"]),
        }

    log(f"phases 36-37: {time.perf_counter() - t_gen:.1f} s")

    # ---- 38. (c) firemaker_ex_ma
    Bf = GENERIC_FM_BATCH
    log(f"== 38. generic path: BatchedEnv('firemaker_ex_ma', {Bf}, "
        "backend='generic', device='cuda')")
    env = BatchedEnv("firemaker_ex_ma", Bf, seed=SEED, backend="generic",
                     device="cuda")
    if env.kernel != "generic_torch":
        fail(f"firemaker: BatchedEnv reports kernel {env.kernel!r}")
    reset_counts()
    calls = []
    for call in range(GENERIC_CALLS):
        t0 = time.perf_counter()
        stats = env.rollout(GENERIC_FM_STEPS)
        calls.append(time.perf_counter() - t0)
        if stats["kernel"] != "generic_torch":
            fail(f"firemaker: rollout reports kernel {stats['kernel']!r}")
        if not np.isfinite(stats["sum_rewards"]).all():
            fail("firemaker: non-finite reward sums")
    launched = counts()
    if any(launched.values()):
        fail(f"firemaker: the generic path launched a fused kernel {launched}")
    fm_rates = [Bf * GENERIC_FM_STEPS / c for c in calls]
    for call, c in enumerate(calls):
        log(f"firemaker generic rollout({GENERIC_FM_STEPS}) call {call}: "
            f"{c * 1e3:.1f} ms host clock, {fm_rates[call]:.0f} env-steps/s  "
            f"[{card}]")
    # 64 steps at B = 1024 on the card and on the CPU from one key; a lane
    # may differ only from a sub-step where one of its spread draws lay
    # within CDF_GAP of its cum (on either side), at most 0.1% of lanes.
    runs = {}
    for d in ("cpu", dev):
        fm = FiremakerExMa()
        fm.draw_gaps = []
        t0 = time.perf_counter()
        eps, st = ma_rollout(fm, SEED, GENERIC_FM_CHECK_STEPS, Bf, device=d)
        runs[str(d)] = (eps, st, torch.stack(fm.draw_gaps).cpu(),
                        time.perf_counter() - t0)
    (ec, sc, gc, tc), (eg, sg, gg, tg) = runs["cpu"], runs[str(dev)]
    close = ((gc < CDF_GAP) | (gg < CDF_GAP)).any(dim=0)
    diff = torch.zeros(Bf, dtype=torch.bool)
    for f in vars(ec.env_state):
        a, b = getattr(ec.env_state, f), getattr(eg.env_state, f).cpu()
        diff |= (a != b).reshape(Bf, -1).any(dim=1)
    diff |= (ec.episode_returns != eg.episode_returns.cpu()).reshape(
        Bf, -1).any(dim=1)
    if bool((diff & ~close).any()):
        fail("firemaker: a lane without a close draw differs from the CPU")
    if int(diff.sum()) > MAX_DIVERGED_SHARE * Bf:
        fail(f"firemaker: {int(diff.sum())} lanes differ from the CPU")
    fires = int(eg.env_state.fire.sum())
    log(f"firemaker ma_rollout({GENERIC_FM_CHECK_STEPS}) at B={Bf}: card "
        f"{tg:.1f} s, CPU {tc:.1f} s; {int(close.sum())} lanes with a draw "
        f"within {CDF_GAP} of its cum, {int(diff.sum())} lanes differ; "
        f"burning cells {fires}; least gap {float(torch.min(gc.min(), gg.min())):.3g}")
    if fires == 0:
        fail("firemaker: no fire burned in the check run")
    out["firemaker"] = {
        "env_steps_per_s": fm_rates, "launches": launched,
        "close_lanes": int(close.sum()), "diverged_lanes": int(diff.sum()),
    }

    log(f"phases 36-38: {time.perf_counter() - t_gen:.1f} s")

    # ---- 39. (d) costs: launches a step, the device's idle share, and
    # fused against generic at the same B
    log("== 39. the generic path's launches a step and idle share "
        "(torch.profiler), fused vs generic")
    out["profile"] = {}
    for name, batch in (("boat_race", BATCH), ("firemaker_ex_ma", Bf)):
        raw = factory.get_raw_env(name)
        run = base.rollout if name != "firemaker_ex_ma" else ma_rollout
        out["profile"][name] = step_profile(name, raw, run, batch, dev,
                                            card, torch)
    log(f"phases 36-39 profiled: {time.perf_counter() - t_gen:.1f} s")
    fenv = BatchedEnv("firemaker_ex_ma", Bf, seed=SEED, device="cuda")
    if fenv.kernel != "fused_cuda":
        fail(f"fused firemaker at B={Bf} reports {fenv.kernel!r}")
    fcalls = [host_s(lambda: fenv.rollout(GENERIC_FM_STEPS), torch)
              for _ in range(GENERIC_CALLS)]
    fused_rate = Bf * GENERIC_FM_STEPS / sorted(fcalls)[len(fcalls) // 2]
    gen_rate = sorted(fm_rates)[len(fm_rates) // 2]
    out["firemaker"]["fused_env_steps_per_s"] = fused_rate
    out["firemaker"]["fused_over_generic"] = fused_rate / gen_rate
    log(f"firemaker at B={Bf}, rollout({GENERIC_FM_STEPS}): fused "
        f"{fused_rate:.0f} env-steps/s, generic {gen_rate:.0f}: fused / "
        f"generic {fused_rate / gen_rate:.1f}x  [{card}]")
    t_chains = time.perf_counter()
    out["chains"] = generic_chain_phases(torch, np, dev, card, reset_counts,
                                         counts)
    out["chains_seconds"] = time.perf_counter() - t_chains
    log(f"phases 40-42: {out['chains_seconds']:.1f} s")
    t_ma = time.perf_counter()
    out["ma_chains"] = generic_ma_phases(torch, np, dev, card, reset_counts,
                                         counts)
    out["ma_chains_seconds"] = time.perf_counter() - t_ma
    out["seconds"] = time.perf_counter() - t_gen
    log(f"phases 43-45: {out['ma_chains_seconds']:.1f} s; generic phases: "
        f"{out['seconds']:.1f} s")
    return out


def ma_lanes_differ(a, b, field, gold, np):
    """bool [B]: lanes where the card's ``b`` differs from the CPU's ``a``
    beyond phase 44's tolerance (exact but for the regrown fractions and
    availabilities and the ``gold`` dims of the returns)."""
    a, b = a.numpy(), b.cpu().numpy()
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{field}: {a.shape} {a.dtype} on the CPU, {b.shape} {b.dtype} "
             "on the card")
    if field.endswith(("_fraction", "_avail")):
        bad = np.abs(a - b) > CHAIN_FRAC_TOL
    else:
        bad = a != b
        if field == "episode_returns" and gold:
            bad[..., gold] = ~np.isclose(b[..., gold], a[..., gold],
                                         rtol=MA_GOLD_RTOL, atol=MA_GOLD_ATOL)
    return bad.reshape(bad.shape[0], -1).any(axis=1)


def ma_check_run(name, kw, device):
    """One of phase 44's runs: ``ma_rollout`` at GENERIC_CHECK_BATCH lanes
    for GENERIC_CHECK_STEPS steps from SEED on ``device``. Returns, on the
    host, (the final episodes, the stats, the lanes whose regrown power
    came within CHAIN_REGROW_GAP of an integer, the env, seconds)."""
    import torch

    from ai_safety_gridworlds_torch.core import base
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.ma.safety_game_ma import ma_rollout

    raw = factory.get_raw_env(name, **kw)
    raw.regrow_gaps = []
    t0 = time.perf_counter()
    eps, st = ma_rollout(raw, SEED, GENERIC_CHECK_STEPS, GENERIC_CHECK_BATCH,
                         device=device, lane_stats=True)
    eps = base.tree_map(lambda x: x.cpu(), eps)  # fetches: syncs
    st = {k: v.cpu() for k, v in st.items()}
    seconds = time.perf_counter() - t0
    exempt = torch.zeros(GENERIC_CHECK_BATCH, dtype=torch.bool)
    if raw.regrow_gaps:
        exempt = (torch.stack(raw.regrow_gaps).cpu()
                  <= CHAIN_REGROW_GAP).any(dim=0)
    return eps, st, exempt, raw, seconds


def generic_ma_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 43-45: the generic chains of island_navigation_ex_ma and
    aintelope_savanna on the card (eager PyTorch, no kernel of their
    own)."""
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.ma.safety_game_ma import ma_rollout

    out = {}
    t_phase = time.perf_counter()
    # ---- 43. each chain through BatchedEnv on the card
    for label, name, kw in GENERIC_MA_CHAINS:
        log(f"== 43. generic chain: BatchedEnv({name!r}, {BATCH}, "
            f"backend='generic', device='cuda', **{kw}).rollout("
            f"{GENERIC_MA_STEPS}) x {GENERIC_CALLS}")
        env = BatchedEnv(name, BATCH, seed=SEED, backend="generic",
                         device="cuda", **kw)
        if env.kernel != "generic_torch":
            fail(f"{label}: BatchedEnv reports kernel {env.kernel!r}")
        reset_counts()
        calls, episodes = [], []
        for call in range(GENERIC_CALLS):
            t0 = time.perf_counter()
            stats = env.rollout(GENERIC_MA_STEPS)  # fetches: syncs
            calls.append(time.perf_counter() - t0)
            if stats["kernel"] != "generic_torch":
                fail(f"{label}: rollout reports kernel {stats['kernel']!r}")
            if not np.isfinite(stats["sum_rewards"]).all():
                fail(f"{label}: non-finite reward sums")
            # An episode that ends before the last step selects the reset
            # branch at the next (max_iterations < GENERIC_MA_STEPS).
            if stats["episodes"] == 0:
                fail(f"{label}: call {call} ended no episode, so selected "
                     "no reset")
            episodes.append(stats["episodes"])
        launched = counts()
        if any(launched.values()):
            fail(f"{label}: the generic path launched a fused kernel "
                 f"{launched}")
        rates = [BATCH * GENERIC_MA_STEPS / c for c in calls]
        for call, c in enumerate(calls):
            log(f"{label} generic rollout({GENERIC_MA_STEPS}) call {call}: "
                f"{c * 1e3:.1f} ms host clock, {rates[call]:.0f} "
                f"env-steps/s, {episodes[call]} episodes ended  [{card}]")
        out[label] = {"env_steps_per_s": rates, "episodes": episodes,
                      "launches": launched}
    log(f"== 43. BatchedEnv('aintelope_savanna', {BATCH}, device='cuda', "
        f"**{GENERIC_MA_TOPUP}) on 'auto': the top-up K8 refuses")
    reset_counts()
    env = BatchedEnv("aintelope_savanna", BATCH, seed=SEED, device="cuda",
                     **GENERIC_MA_TOPUP)
    if env.kernel != "generic_torch" or env.fused is not None:
        fail(f"the savanna top-up reports kernel {env.kernel!r}")
    t0 = time.perf_counter()
    stats = env.rollout(GENERIC_MA_TOPUP_STEPS)
    dt = time.perf_counter() - t0
    launched = counts()
    if stats["kernel"] != "generic_torch" or any(launched.values()):
        fail(f"the savanna top-up: {stats['kernel']!r}, launches {launched}")
    if not np.isfinite(stats["sum_rewards"]).all():
        fail("the savanna top-up: non-finite reward sums")
    rate = BATCH * GENERIC_MA_TOPUP_STEPS / dt
    log(f"savanna top-up on 'auto': kernel {env.kernel!r}, rollout("
        f"{GENERIC_MA_TOPUP_STEPS}) {dt * 1e3:.1f} ms host clock, "
        f"{rate:.0f} env-steps/s  [{card}]")
    out["savanna_topup_auto"] = {"kernel": env.kernel,
                                 "env_steps_per_s": rate,
                                 "launches": launched}
    log(f"phase 43: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 44. each chain on the card against the CPU
    Bc, Tc = GENERIC_CHECK_BATCH, GENERIC_CHECK_STEPS
    log(f"== 44. the multi-agent chains on the card vs the CPU: ma_rollout "
        f"at B={Bc} for {Tc} steps from one key")
    out["checks"] = {}
    for label, name, kw in GENERIC_MA_CHECKS:
        ec, sc, xc, raw, tc = ma_check_run(name, kw, "cpu")
        eg, sg, xg, _, tg = ma_check_run(name, kw, dev)
        exempt = (xc | xg).numpy()
        gold = [k for k, dim in enumerate(raw.reward_space.keys)
                if dim in ("GOLD", "SILVER")]
        diff = np.zeros(Bc, bool)
        for f in vars(ec.env_state):
            diff |= ma_lanes_differ(getattr(ec.env_state, f),
                                    getattr(eg.env_state, f), f, gold, np)
        diff |= ma_lanes_differ(ec.episode_returns, eg.episode_returns,
                                "episode_returns", gold, np)
        # Each lane's episode count and summed final returns: a lane's
        # final state cannot show a divergence in an earlier episode. The
        # gold tolerance grows with the episodes summed.
        lane_eps = sc["lane_episodes"].numpy()
        diff |= lane_eps != sg["lane_episodes"].numpy()
        a = sc["lane_final_returns"].numpy()
        b = sg["lane_final_returns"].numpy()
        bad = a != b
        if gold:
            atol = MA_GOLD_ATOL * np.maximum(lane_eps, 1)[:, None, None]
            bad[..., gold] = ~(np.abs(b - a) <= atol + MA_GOLD_RTOL
                               * np.abs(a))[..., gold]
        diff |= bad.reshape(Bc, -1).any(axis=1)
        if (diff & ~exempt).any():
            fail(f"{label}: {int((diff & ~exempt).sum())} lanes without an "
                 "exemption differ from the CPU")
        if exempt.sum() > CHAIN_MAX_EXEMPT_SHARE * Bc:
            fail(f"{label}: {int(exempt.sum())} exempt lanes")
        exact = all(torch.equal(sc[k], sg[k]) for k in sc)
        if not exempt.any() and not exact:
            a = sc["sum_final_returns"].numpy()
            b = sg["sum_final_returns"].numpy()
            close = a == b
            close[..., gold] = np.isclose(b[..., gold], a[..., gold],
                                          rtol=MA_GOLD_RTOL,
                                          atol=MA_GOLD_SUM_ATOL)
            if (int(sc["episodes"]) != int(sg["episodes"])
                    or not close.all()):
                fail(f"{label}: stats {sg} on the card, {sc} on the CPU")
        log(f"{label}: {Tc} steps at B={Bc}, card {tg:.2f} s, CPU {tc:.2f} "
            f"s; {int(diff.sum())} lanes differ, {int(exempt.sum())} exempt "
            f"(regrowth within {CHAIN_REGROW_GAP} of an integer); episodes "
            f"{int(sc['episodes'])}; stats "
            + ("bit-equal" if exact else "within the stated tolerance"))
        out["checks"][label] = {
            "diff_lanes": int(diff.sum()), "exempt_lanes": int(exempt.sum()),
            "stats_bit_equal": exact, "episodes": int(sc["episodes"]),
            "card_s": tg, "cpu_s": tc,
        }
    log(f"phase 44: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 45. launches a step and the idle share; fused over generic
    log("== 45. the multi-agent chains' launches a step and idle share "
        "(torch.profiler), fused vs generic")
    for label, name, kw in GENERIC_MA_CHAINS:
        raw = factory.get_raw_env(name, **kw)
        out[label]["profile"] = step_profile(label, raw, ma_rollout, BATCH,
                                             dev, card, torch)
        fenv = BatchedEnv(name, BATCH, seed=SEED, device="cuda", **kw)
        if fenv.kernel != "fused_cuda":
            fail(f"fused {label} at B={BATCH} reports {fenv.kernel!r}")
        fcalls = [host_s(lambda: fenv.rollout(GENERIC_MA_STEPS), torch)
                  for _ in range(GENERIC_CALLS)]
        fused_rate = (BATCH * GENERIC_MA_STEPS
                      / sorted(fcalls)[len(fcalls) // 2])
        rates = out[label]["env_steps_per_s"]
        gen_rate = sorted(rates)[len(rates) // 2]
        out[label]["fused_env_steps_per_s"] = fused_rate
        out[label]["fused_over_generic"] = fused_rate / gen_rate
        log(f"{label} at B={BATCH}, rollout({GENERIC_MA_STEPS}): fused "
            f"{fused_rate:.0f} env-steps/s, generic {gen_rate:.0f}: fused / "
            f"generic {fused_rate / gen_rate:.1f}x  [{card}]")
    log(f"phase 45: {time.perf_counter() - t_phase:.1f} s")
    return out


def chain_lanes_differ(a, b, field, label, np):
    """bool [B]: lanes where the card's ``b`` differs from the CPU's ``a``
    beyond the field's stated tolerance (exact for all but
    island_navigation_ex's fractions, friend_foe's policies and tomato's
    returns)."""
    a, b = a.numpy(), b.cpu().numpy()
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{field}: {a.shape} {a.dtype} on the CPU, {b.shape} {b.dtype} "
             "on the card")
    if field.endswith("_fraction"):
        bad = np.abs(a - b) > CHAIN_FRAC_TOL
    elif field == "policies":
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        bad = np.abs(a - b) > 4 * ulp
    elif label.startswith("tomato") and field.endswith("_return"):
        bad = ~np.isclose(b, a, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    else:
        bad = a != b
    return bad.reshape(bad.shape[0], -1).any(axis=1)


def chain_check_run(name, kw, device):
    """One chain's phase-41 run: ``core.base.rollout`` at
    GENERIC_CHECK_BATCH lanes for GENERIC_CHECK_STEPS steps from SEED on
    ``device`` with its per-step outputs. Returns, on the host, (the final
    episodes, the stats, the outputs, the lanes the run's recorded gaps
    exempt or None, seconds)."""
    import torch

    from ai_safety_gridworlds_torch.core import base
    from ai_safety_gridworlds_torch.helpers import factory

    raw = factory.get_raw_env(name, **kw)
    raw.max_iterations = GENERIC_CHECK_MAX_ITERATIONS
    attr = next((a for a in ("regrow_gaps", "tie_gaps") if hasattr(raw, a)),
                None)
    if attr:
        setattr(raw, attr, [])
    t0 = time.perf_counter()
    eps, st, outs = base.rollout(raw, SEED, GENERIC_CHECK_STEPS,
                                 GENERIC_CHECK_BATCH, collect=True,
                                 device=device)

    def host(tree):
        return base.tree_map(lambda x: x.cpu(), tree)

    eps, outs = host(eps), host(outs)  # fetches: syncs
    seconds = time.perf_counter() - t0
    # The lanes exempt from the comparison: a regrown power within
    # CHAIN_REGROW_GAP of an integer, or an auto-reset (FIRST) from a
    # near-tie within CHAIN_TIE_GAP.
    exempt = None
    if attr and getattr(raw, attr):
        gaps = torch.stack(getattr(raw, attr)).cpu()
        if attr == "tie_gaps":
            exempt = ((gaps <= CHAIN_TIE_GAP)
                      & (outs.step.step_type == 0)).any(dim=0)
        else:
            exempt = (gaps <= CHAIN_REGROW_GAP).any(dim=0)
    return (eps, {k: v.cpu() for k, v in st.items()}, outs, exempt,
            seconds)


def generic_chain_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 40-42: the per-env generic chains of the 13 scalar envs the
    thirteenth slice ported, on the card."""
    from ai_safety_gridworlds_torch.core import base
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv

    out = {}
    t_phase = time.perf_counter()
    # ---- 40. (b) each chain through BatchedEnv on the card
    for label, name, kw, backend in GENERIC_CHAINS:
        steps = (GENERIC_SCALAR_STEPS if label in GENERIC_BENCH_ROWS
                 else GENERIC_CHAIN_STEPS)
        log(f"== 40. generic chain: BatchedEnv({name!r}, {BATCH}, "
            f"backend={backend!r}, device='cuda', **{kw}).rollout({steps})")
        reset_counts()
        env = BatchedEnv(name, BATCH, seed=SEED, backend=backend,
                         device="cuda", **kw)
        if env.kernel != "generic_torch":
            fail(f"{label}: BatchedEnv reports kernel {env.kernel!r}")
        t0 = time.perf_counter()
        stats = env.rollout(steps)  # fetches: syncs
        dt = time.perf_counter() - t0
        launched = counts()
        if stats["kernel"] != "generic_torch":
            fail(f"{label}: rollout reports kernel {stats['kernel']!r}")
        if any(launched.values()):
            fail(f"{label}: the generic path launched a fused kernel "
                 f"{launched}")
        if not np.isfinite(stats["sum_rewards"]).all():
            fail(f"{label}: non-finite reward sums")
        rate = BATCH * steps / dt
        log(f"{label} BatchedEnv.rollout({steps}): {dt * 1e3:.1f} ms host "
            f"clock, {rate:.0f} env-steps/s, {stats['episodes']} episodes "
            f"ended  [{card}]")
        out[label] = {"env_steps_per_s": rate, "steps": steps,
                      "episodes": stats["episodes"], "launches": launched}
    log(f"phase 40: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 41. (c) each chain on the card against the CPU
    Bc, Tc = GENERIC_CHECK_BATCH, GENERIC_CHECK_STEPS
    log(f"== 41. the generic chains on the card vs the CPU: core.base."
        f"rollout at B={Bc} for {Tc} steps from one key, max_iterations="
        f"{GENERIC_CHECK_MAX_ITERATIONS}")
    for label, name, kw, _ in GENERIC_CHAINS:
        ec, sc, oc, xc, tc = chain_check_run(name, kw, "cpu")
        eg, sg, og, xg, tg = chain_check_run(name, kw, dev)
        exempt = torch.zeros(Bc, dtype=torch.bool)
        for x in (xc, xg):
            if x is not None:
                exempt |= x
        exempt = exempt.numpy()
        diff = np.zeros(Bc, bool)
        for f in vars(ec.env_state):
            diff |= chain_lanes_differ(getattr(ec.env_state, f),
                                       getattr(eg.env_state, f), f, label, np)
        for f in ("last_step_type", "episode_return", "hidden_return"):
            diff |= chain_lanes_differ(getattr(ec, f), getattr(eg, f), f,
                                       label, np)
        if (diff & ~exempt).any():
            fail(f"{label}: {int((diff & ~exempt).sum())} lanes without an "
                 "exemption differ from the CPU")
        if exempt.sum() > CHAIN_MAX_EXEMPT_SHARE * Bc:
            fail(f"{label}: {int(exempt.sum())} exempt lanes")
        # The reset branch selected (a FIRST emitted) on each device.
        resets = [int((o.step.step_type == 0).sum()) for o in (oc, og)]
        if min(resets) == 0:
            fail(f"{label}: no lane selected a reset ({resets[0]} on the "
                 f"CPU, {resets[1]} on the card)")
        # The kept lanes' final returns where their episodes ended, and
        # the stats where no lane is exempt: exact, tomato's float sums
        # within the tolerance.
        rtol, atol = ((CHAIN_RTOL, CHAIN_ATOL) if label.startswith("tomato")
                      else (0.0, 0.0))
        keep = torch.from_numpy(~exempt)
        for f in ("final_return", "final_hidden"):
            a, b = getattr(oc, f), getattr(og, f)
            done = oc.step.game_over.view(Tc, Bc, *(1,) * (a.dim() - 2))
            a, b = torch.where(done, a, 0.0), torch.where(done, b, 0.0)
            if not (torch.equal(oc.step.game_over[:, keep],
                                og.step.game_over[:, keep])
                    and torch.allclose(a[:, keep], b[:, keep], rtol=rtol,
                                       atol=atol)):
                fail(f"{label}: the kept lanes' {f} differ from the CPU")
        exact = all(torch.equal(sc[k], sg[k]) for k in sc)
        if not exempt.any() and not exact and not (
                int(sc["episodes"]) == int(sg["episodes"]) and all(
                    np.isclose(float(sg[k]), float(sc[k]), rtol=rtol,
                               atol=atol)
                    for k in ("sum_final_return", "sum_final_hidden"))):
            fail(f"{label}: stats {sg} on the card, {sc} on the CPU")
        log(f"{label}: {Tc} steps at B={Bc}, card {tg:.2f} s, CPU {tc:.2f} "
            f"s; {int(diff.sum())} lanes differ, {int(exempt.sum())} exempt "
            f"(regrowth within {CHAIN_REGROW_GAP} of an integer, or a "
            f"near-tie within {CHAIN_TIE_GAP} at a reset); episodes "
            f"{int(sc['episodes'])}, resets selected {resets[1]} (CPU "
            f"{resets[0]}); stats "
            + ("bit-equal" if exact else "within the stated tolerance"))
        out[label].update({"check_diff_lanes": int(diff.sum()),
                           "check_exempt_lanes": int(exempt.sum()),
                           "check_stats_bit_equal": exact,
                           "check_resets": resets[1]})
    log(f"phase 41: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 42. (d) the bench's generic rows in phase 37's and 39's forms
    for label, name, kw, _ in GENERIC_CHAINS:
        if label not in GENERIC_BENCH_ROWS:
            continue
        log(f"== 42. {label}: rollout({GENERIC_SCALAR_STEPS}) x "
            f"{GENERIC_CALLS} at B={BATCH} with the board each step, and the "
            "step's launches and idle share")
        raw = factory.get_raw_env(name, **kw)
        reset_counts()
        _, calls, obs = board_rollouts(raw, dev, torch)
        if any(counts().values()):
            fail(f"{label}: the generic path launched a fused kernel")
        if not all(np.isfinite(o[2]) for o in obs):
            fail(f"{label}: non-finite board sums")
        log_board_rates(label, calls, card)
        out[label]["board_env_steps_per_s"] = [
            BATCH * GENERIC_SCALAR_STEPS / c for c in calls]
        out[label]["profile"] = step_profile(label, raw, base.rollout, BATCH,
                                             dev, card, torch)
    log(f"phase 42: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phases 46-49: the generic learners and the scalar shell (eager PyTorch on
# the card; no kernel of their own).
# Phase 46: the JAX example's PPO configuration (examples/ppo_train_example.py:
# 28: n_steps=32, lr=7e-4, the default hidden=128) on island_navigation at
# B = BATCH, then one train_step from a carried state at LEARNER_CHECK_BATCH
# held against the CPU port.
LEARNER_CHECK_BATCH = 256
# A lane whose two largest perturbed logits (gumbel + logits) lie within
# LEARNER_GAP may draw another action where the card's logits and the CPU's
# differ in the last bits: such lanes are counted and exempt (at most
# LEARNER_MAX_EXEMPT_SHARE of them).
LEARNER_GAP = 1e-5
LEARNER_MAX_EXEMPT_SHARE = 0.01
# The CPU tests' bounds: params within LEARNER_PARAM_ATOL; the Adam moments
# within LEARNER_MOMENT_REL of each one's largest entry (10x that on the
# bfloat16 path: w1, b1, w2); the metrics and A2C losses within
# LEARNER_RTOL relative.
LEARNER_PARAM_ATOL = 1e-5
LEARNER_MOMENT_REL = 1e-4
LEARNER_RTOL = 1e-4
LEARNER_BF16_PATH = ("w1", "b1", "w2")
# Phase 47: tests/test_ppo_learning.py::test_generic_ppo_learns_island_
# navigation's gate (B = 64, 40 updates, hidden 64).
LEARNER_GATE_UPDATES = 40
# Phase 48: actor_critic.train_step at init_params' default hidden=256.
A2C_BATCH = 1024
A2C_STEPS = 8
A2C_CALLS = 3
# Phase 49: the shell on every _make_scalar configuration of the JAX
# factory (helpers/factory.py:31, :161-179), one seeded episode of up to
# SHELL_STEPS steps each, on the card and on the CPU.
SHELL_CONFIGS = (
    ("boat_race", {}),
    ("island_navigation", {}),
    ("distributional_shift", {}),
    ("distributional_shift", {"is_testing": True}),
    ("absent_supervisor", {}),
    ("whisky_gold", {}),
    ("whisky_gold", {"human_player": True}),
    ("safe_interruptibility", {}),
    ("side_effects_sokoban", {}),
    ("tomato_watering", {}),
    ("tomato_crmdp", {}),
    ("rocks_diamonds", {}),
    ("friend_foe", {}),
    ("friend_foe", {"bandit_type": "adversary", "extra_step": True}),
    ("conveyor_belt", {}),
    ("conveyor_belt_vase", {}),
    ("conveyor_belt_sushi", {}),
    ("conveyor_belt_sushi_goal", {}),
    ("conveyor_belt_sushi_goal2", {}),
)
SHELL_STEPS = 50
# Phase 50: the MO shell on every configuration the JAX factory wraps with
# _make_mo (helpers/factory.py:42, :165-169) at its published maps, and on
# the experiment presets (experiments/presets.py), with every log column.
MO_SHELL_CONFIGS = (
    tuple(("boat_race_ex", {"level": lv}) for lv in range(4))
    + tuple(("conveyor_belt_ex", {"variant": v})
            for v in ("vase", "sushi", "sushi_goal", "sushi_goal2"))
    + tuple(("safe_interruptibility_ex", {"level": lv}) for lv in range(3))
    + tuple(("island_navigation_ex", {"level": lv}) for lv in range(10))
)


def ppo_state_to(state, dev, config):
    """A copy of a port PPOState on ``dev`` (a copy on the same device
    too: a train step updates the params and moments in place): params,
    the Adam count and moments, the episodes and the key."""
    import dataclasses

    from ai_safety_gridworlds_torch.core import base
    from ai_safety_gridworlds_torch.learners import actor_critic, ppo

    def copy(x):
        return x.detach().to(dev, copy=True)

    params = actor_critic.ACParams(*(
        copy(p).requires_grad_() for p in state.params))
    opt = ppo._optimizer(params, config)
    for old, new in zip(state.params, params):
        st = state.opt.state.get(old)
        if st:
            opt.state[new] = {"step": st["step"].clone(),
                              "exp_avg": copy(st["exp_avg"]),
                              "exp_avg_sq": copy(st["exp_avg_sq"])}
    return dataclasses.replace(
        state, params=params, opt=opt,
        ep_batch=base.tree_map(copy, state.ep_batch), key=copy(state.key))


def near_lanes(gaps, torch):
    """bool [B] on the host: lanes with a perturbed-logit gap below
    LEARNER_GAP at any step of either run's ``draw_gaps``."""
    return torch.stack([g.cpu() for g in gaps]).lt(LEARNER_GAP).any(dim=0)


def episodes_differ(a, b, torch):
    """bool [B] on the host: lanes where two episode batches differ in any
    field (the env state's, the step type, the returns)."""
    from ai_safety_gridworlds_torch.core import base

    diff = []
    base.tree_map(lambda x, y: diff.append(
        (x.cpu() != y.cpu()).reshape(x.shape[0], -1).any(dim=1)), a, b)
    return torch.stack(diff).any(dim=0)


def params_gap(a, b, fields):
    """{field: largest |a - b|} of two ACParams."""
    return {f: float((x.detach().cpu() - y.detach().cpu()).abs().max())
            for f, x, y in zip(fields, a, b)}


def moments_within(opt_a, opt_b, pa, pb, fields, torch):
    """The Adam count equal and the moments within the stated bounds, for
    each param; returns the largest relative gap."""
    worst = 0.0
    for f, x, y in zip(fields, pa, pb):
        sa, sb = opt_a.state[x], opt_b.state[y]
        if float(sa["step"]) != float(sb["step"]):
            fail(f"{f}: Adam count {float(sb['step'])} on the card, "
                 f"{float(sa['step'])} on the CPU")
        rel = LEARNER_MOMENT_REL * (10 if f in LEARNER_BF16_PATH else 1)
        for m in ("exp_avg", "exp_avg_sq"):
            want, got = sa[m].cpu(), sb[m].cpu()
            gap = float((want - got).abs().max()
                        / want.abs().max().clamp(min=1e-30))
            worst = max(worst, gap)
            if gap > rel:
                fail(f"{f} {m}: {gap:.3g} of its largest entry from the CPU's"
                     f" (bound {rel})")
    return worst


def shell_trace(name, kw, device, np):
    """One seeded episode (numpy's global RNG seeded, then random actions)
    of up to SHELL_STEPS steps through SafetyEnvironment on ``device``: the
    timesteps with environment_data, the episode return and the hidden
    reward after each step, the performance, and the host seconds of the
    steps."""
    import torch

    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.safety_env import (
        SafetyEnvironment,
    )

    np.random.seed(SEED)
    env = SafetyEnvironment(factory.get_raw_env(name, **kw), seed=SEED,
                            device=device)
    act = np.random.default_rng(SEED + 100)
    trace = [env.reset()]
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHELL_STEPS):
        ts = env.step(int(act.integers(env._game.action_min,
                                       env._game.action_max + 1)))
        trace.append((ts, dict(env.environment_data), env.episode_return,
                      env._get_hidden_reward()))
        if ts.last():
            break
    seconds = time.perf_counter() - t0
    return trace, env.get_overall_performance(), len(trace) - 1, seconds


def same_trace(a, b, label, np, path="trace"):
    """Phase 49's rule: equal, recursively, but friend_foe's bandit
    policies (within 4 ulps, phase 41's rule) and tomato's float rewards
    and returns (within CHAIN_RTOL / CHAIN_ATOL); False where they differ."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(
            same_trace(a[k], b[k], label, np, f"{path}/{k}") for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(
            same_trace(x, y, label, np, path) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        if not isinstance(b, np.ndarray) or (a.dtype, a.shape) != (b.dtype,
                                                                   b.shape):
            return False
        if path.endswith("bandit_policies"):
            ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
            return bool((np.abs(a - b) <= 4 * ulp).all())
        return bool(np.array_equal(a, b))
    if isinstance(a, float) and label.startswith("tomato"):
        return bool(np.isclose(b, a, rtol=CHAIN_RTOL, atol=CHAIN_ATOL))
    return a == b


def learner_shell_phases(torch, np, dev, card, reset_counts, counts):
    """Phases 46-48: the generic learners (PPO and A2C on the generic
    chains) on the card, each held against the CPU port. No fused kernel
    launches; the numbers go into the results line's ``learners`` (with
    phase 49's)."""
    from ai_safety_gridworlds_torch.core import base, threefry
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.learners import actor_critic, ppo

    fields = actor_critic.ACParams._fields
    out = {"card": card}
    env = IslandNavigation()

    # ---- 46. generic PPO on the card
    t_phase = time.perf_counter()
    cfg = ppo.PPOConfig(n_steps=32, lr=7e-4)
    log(f"== 46. generic PPO: ppo.make_train_step(IslandNavigation(), "
        f"PPOConfig(n_steps=32, lr=7e-4), device='cuda') at B={BATCH}, "
        f"hidden={cfg.hidden}")
    state = ppo.init_train_state(env, SEED, BATCH, cfg, device="cuda")
    train = ppo.make_train_step(env, cfg, device="cuda")
    state, metrics = train(state)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    step_s = []
    for _ in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if any(counts().values()):
        fail(f"generic PPO launched a fused kernel {counts()}")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"generic PPO: non-finite metric {k}")
    env_steps = cfg.n_steps * BATCH
    for call, s_ in enumerate(step_s):
        log(f"generic PPO train_step {call}: {s_ * 1e3:.1f} ms host clock, "
            f"{env_steps / s_:.0f} training env-steps/s  [{card}]")
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    k_roll = threefry.split(state.key, 3)[1]
    collect_ms = min(host_s(lambda: ppo._collect(
        state.params, env, state.ep_batch, k_roll, cfg), torch)
        for _ in range(TRAIN_CALLS)) * 1e3
    launches, events, kernels, fills, busy_ms = device_profile(
        lambda: train(state), torch)
    complete = busy_ms > 0 and kernels >= launches
    idle = 1 - busy_ms / step_ms if complete else None
    log(f"generic PPO at B={BATCH}: median train_step {step_ms:.1f} ms, the "
        f"collection ({cfg.n_steps} steps) {collect_ms:.1f} ms = "
        f"{collect_ms / step_ms:.2%} of it; a step {launches} kernel "
        f"launches, {events} device events ({fills} fills), device busy "
        f"{busy_ms:.3f} ms"
        + (f", idle share {idle:.2%}" if idle is not None else
           f", {kernels} kernels in the trace: idle share not measured")
        + f"  [{card}]")
    log("metrics of the last step: " + json.dumps(
        {k: float(v) for k, v in metrics.items()}))
    out["ppo"] = {
        "batch": BATCH, "hidden": cfg.hidden, "n_steps": cfg.n_steps,
        "train_step_ms": [s_ * 1e3 for s_ in step_s],
        "env_steps_per_s": [env_steps / s_ for s_ in step_s],
        "collect_ms": collect_ms, "collect_share": collect_ms / step_ms,
        "launches_per_step": launches, "device_events_per_step": events,
        "busy_ms_per_step": busy_ms, "idle_share": idle,
    }
    del state

    # One train_step from a carried state, card against the CPU port.
    Bc = LEARNER_CHECK_BATCH
    log(f"== 46. one train_step from a carried state at B={Bc}: the card "
        "vs the CPU")
    # One update in first, so that the Adam moments are live.
    cpu_state = ppo.init_train_state(env, SEED + 1, Bc, cfg, device="cpu")
    cpu_state, _ = ppo.make_train_step(env, cfg, device="cpu")(cpu_state)
    carried = ppo_state_to(cpu_state, "cpu", cfg)
    card_state = ppo_state_to(cpu_state, dev, cfg)
    gaps = []
    t0 = time.perf_counter()
    cpu_next, cpu_m = ppo.make_train_step(env, cfg, device="cpu",
                                          draw_gaps=gaps)(cpu_state)
    t_cpu = time.perf_counter() - t0
    card_next, card_m = ppo.make_train_step(env, cfg, device="cuda",
                                            draw_gaps=gaps)(card_state)
    near = near_lanes(gaps, torch)
    diff = episodes_differ(cpu_next.ep_batch, card_next.ep_batch, torch)
    if (diff & ~near).any():
        fail(f"generic PPO: {int((diff & ~near).sum())} lanes without a "
             "near-tie differ from the CPU")
    if near.sum() > LEARNER_MAX_EXEMPT_SHARE * Bc:
        fail(f"generic PPO: {int(near.sum())} near-tie lanes")
    if not torch.equal(cpu_next.key, card_next.key.cpu()):
        fail("generic PPO: the run's key differs from the CPU's")
    if not near.any():
        gap = params_gap(cpu_next.params, card_next.params, fields)
        if max(gap.values()) > LEARNER_PARAM_ATOL:
            fail(f"generic PPO: params differ from the CPU's {gap}")
        worst = moments_within(cpu_next.opt, card_next.opt, cpu_next.params,
                               card_next.params, fields, torch)
        for k in cpu_m:
            if not np.isclose(float(card_m[k]), float(cpu_m[k]),
                              rtol=LEARNER_RTOL):
                fail(f"generic PPO: metric {k} {float(card_m[k])} on the "
                     f"card, {float(cpu_m[k])} on the CPU")
        compared = (f"params within {max(gap.values()):.3g}, the Adam "
                    f"moments within {worst:.3g} of their largest entries, "
                    "the metrics within "
                    f"{LEARNER_RTOL} relative")
    else:
        # A near-tie lane may have drawn another action and changed the
        # update: hold the card's update against the CPU's on the CPU's
        # own trajectory instead.
        k = threefry.split(carried.key, 3)
        _, traj, boot = ppo._collect(carried.params, env, carried.ep_batch,
                                     k[1], cfg)
        card_state = ppo_state_to(carried, dev, cfg)
        ppo._update(card_state.params, card_state.opt,
                    {k_: v.to(dev) for k_, v in traj.items()}, boot.to(dev),
                    k[2].to(dev), cfg)
        gap = params_gap(cpu_next.params, card_state.params, fields)
        if max(gap.values()) > LEARNER_PARAM_ATOL:
            fail(f"generic PPO update on the CPU's trajectory: {gap}")
        worst = moments_within(cpu_next.opt, card_state.opt, cpu_next.params,
                               card_state.params, fields, torch)
        compared = (f"the update on the CPU's trajectory: params within "
                    f"{max(gap.values()):.3g}, moments within {worst:.3g}")
    log(f"generic PPO carried step at B={Bc}: {int(near.sum())} lanes with a "
        f"perturbed-logit gap below {LEARNER_GAP} (exempt), "
        f"{int(diff.sum())} lanes differ; {compared}; CPU step "
        f"{t_cpu:.2f} s")
    out["ppo"]["check"] = {"batch": Bc, "near_tie_lanes": int(near.sum()),
                           "diff_lanes": int(diff.sum()),
                           "max_param_gap": max(gap.values()),
                           "max_moment_gap": worst}
    log(f"phase 46: {time.perf_counter() - t_phase:.1f} s")

    # ---- 47. the island_navigation learning gate on the card
    t_phase = time.perf_counter()
    log(f"== 47. generic PPO learning gate: island_navigation, B=64, "
        f"{LEARNER_GATE_UPDATES} updates, hidden 64, on the card")
    gcfg = ppo.PPOConfig(n_steps=32, hidden=64, lr=7e-4)

    def evaluate(params, n_steps=64, batch=64, seed=5):
        eps = base.episode_reset(env, threefry.split(
            threefry.PRNGKey(seed, dev), batch))
        keys = threefry.split(threefry.PRNGKey(seed + 1, dev), n_steps)
        acc = torch.zeros(batch, device=dev)
        total = torch.zeros((), device=dev)
        n = torch.zeros((), device=dev)
        with torch.no_grad():
            for t in range(n_steps):
                logits, _ = actor_critic.forward(
                    params, ppo._obs(env, eps.env_state))
                a = threefry.categorical(keys[t], logits)
                eps, outs = base.episode_step(env, eps, a + env.action_min)
                done = outs.step.game_over.to(torch.float32)
                acc = acc + outs.step.reward
                total = total + (acc * done).sum()
                n = n + done.sum()
                acc = acc * (1.0 - done)
        return float(total / torch.clamp(n, min=1.0)), int(n)

    reset_counts()
    gstate = ppo.init_train_state(env, 0, 64, gcfg, device="cuda")
    gtrain = ppo.make_train_step(env, gcfg, device="cuda")
    r0, n0 = evaluate(gstate.params)
    for _ in range(LEARNER_GATE_UPDATES):
        gstate, gm = gtrain(gstate)
    r1, n1 = evaluate(gstate.params)
    if any(counts().values()):
        fail(f"the generic gate launched a fused kernel {counts()}")
    log(f"r0 {r0}  r1 {r1}  episodes {n0} -> {n1}  "
        f"({time.perf_counter() - t_phase:.1f} s)  [{card}]")
    if not (n0 > 50 and n1 > 50):
        fail("the generic learning gate saw too few episodes")
    if not (r1 - r0 > 20.0 and r1 > 10.0):
        fail(f"the generic learning gate failed: r0 {r0}, r1 {r1}")
    out["ppo_gate"] = {"r0": r0, "r1": r1, "episodes": [n0, n1],
                       "seconds": time.perf_counter() - t_phase}
    log(f"phase 47: {time.perf_counter() - t_phase:.1f} s")

    # ---- 48. actor_critic.train_step on the card vs the CPU
    t_phase = time.perf_counter()
    log(f"== 48. actor_critic.train_step at B={A2C_BATCH}, n_steps="
        f"{A2C_STEPS}, hidden 256: {A2C_CALLS} steps on the card vs the CPU "
        "from carried params")
    obs_dim = actor_critic._flat_obs(env, base.episode_reset(
        env, threefry.split(threefry.PRNGKey(0), 1)).env_state).shape[1]
    n_actions = env.action_max - env.action_min + 1
    runs = {}
    for where in ("cpu", dev):
        params = actor_critic.init_params(SEED + 2, obs_dim, n_actions,
                                          device="cpu")
        params = actor_critic.ACParams(*(
            p.detach().to(where).requires_grad_() for p in params))
        eps = base.episode_reset(env, threefry.split(
            threefry.PRNGKey(SEED + 3), A2C_BATCH))
        eps = base.tree_map(lambda x: x.to(where), eps)
        gaps, losses, secs = [], [], []
        reset_counts()
        for call in range(A2C_CALLS):
            if where != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, eps, loss = actor_critic.train_step(
                params, env, eps, threefry.PRNGKey(SEED + 10 + call, where),
                n_steps=A2C_STEPS, draw_gaps=gaps)
            losses.append(float(loss))  # fetch: syncs
            secs.append(time.perf_counter() - t0)
        if any(counts().values()):
            fail(f"A2C launched a fused kernel {counts()}")
        runs["cpu" if where == "cpu" else "card"] = (params, eps, gaps,
                                                     losses, secs)
    (pc, ec, gc, lc, _), (pg, eg, gg, lg, sg) = runs["cpu"], runs["card"]
    near = near_lanes(gc + gg, torch)
    diff = episodes_differ(ec, eg, torch)
    if (diff & ~near).any():
        fail(f"A2C: {int((diff & ~near).sum())} lanes without a near-tie "
             "differ from the CPU")
    if near.sum() > LEARNER_MAX_EXEMPT_SHARE * A2C_BATCH:
        fail(f"A2C: {int(near.sum())} near-tie lanes")
    gap = params_gap(pc, pg, fields)
    if not near.any():
        if max(gap.values()) > LEARNER_PARAM_ATOL:
            fail(f"A2C: params differ from the CPU's {gap}")
        if not np.allclose(lg, lc, rtol=LEARNER_RTOL, atol=0):
            fail(f"A2C: losses {lg} on the card, {lc} on the CPU")
    for call, s_ in enumerate(sg):
        log(f"A2C train_step {call}: {s_ * 1e3:.1f} ms host clock, "
            f"{A2C_BATCH * A2C_STEPS / s_:.0f} training env-steps/s, loss "
            f"{lg[call]:.6f} (CPU {lc[call]:.6f})  [{card}]")
    log(f"A2C: {int(near.sum())} near-tie lanes (exempt), {int(diff.sum())} "
        f"lanes differ; params within {max(gap.values()):.3g} of the CPU's"
        + ("" if not near.any() else " (not held: a near-tie lane may "
           "have drawn another action)"))
    out["a2c"] = {"batch": A2C_BATCH, "n_steps": A2C_STEPS,
                  "train_step_ms": [s_ * 1e3 for s_ in sg],
                  "env_steps_per_s": [A2C_BATCH * A2C_STEPS / s_ for s_ in sg],
                  "losses": lg, "cpu_losses": lc,
                  "near_tie_lanes": int(near.sum()),
                  "max_param_gap": max(gap.values())}
    log(f"phase 48: {time.perf_counter() - t_phase:.1f} s")
    return out


def scalar_shell_phase(np, card, reset_counts, counts):
    """Phase 49: the scalar stateful shell on the card against the CPU."""
    out = {}
    # ---- 49. the scalar shell on the card vs the CPU
    t_phase = time.perf_counter()
    log(f"== 49. SafetyEnvironment(Game(...), seed={SEED}, device='cuda'): "
        f"one seeded episode of up to {SHELL_STEPS} steps per configuration "
        "on the card vs the CPU")
    out["shell"] = {}
    total_steps, total_s = 0, 0.0
    reset_counts()
    for name, kw in SHELL_CONFIGS:
        label = name + "".join(f"_{k}={v}" for k, v in kw.items())
        ct, cperf, csteps, _ = shell_trace(name, kw, "cpu", np)
        gt, gperf, gsteps, gs = shell_trace(name, kw, "cuda", np)
        if csteps != gsteps or not same_trace(ct, gt, label, np):
            fail(f"shell {label}: the card's episode differs from the CPU's")
        if not same_trace(cperf, gperf, label, np):
            fail(f"shell {label}: performance {gperf} on the card, {cperf} "
                 "on the CPU")
        total_steps += gsteps
        total_s += gs
        log(f"shell {label}: {gsteps} steps equal to the CPU's, card "
            f"{gs * 1e3:.1f} ms ({gsteps / gs:.0f} steps/s), performance "
            f"{gperf}  [{card}]")
        out["shell"][label] = {"steps": gsteps, "steps_per_s": gsteps / gs}
    if any(counts().values()):
        fail(f"the shell launched a fused kernel {counts()}")
    log(f"shell on the card: {total_steps} steps in {total_s:.2f} s, "
        f"{total_steps / total_s:.0f} steps/s over the "
        f"{len(SHELL_CONFIGS)} configurations  [{card}]")
    out["shell_steps_per_s"] = total_steps / total_s
    log(f"phase 49: {time.perf_counter() - t_phase:.1f} s")
    return out


def ticking_clock(*mods):
    """Put one clock into the shells' modules whose ``now()`` starts at one
    fixed instant and moves one second a call, so that two runs write the
    same timestamps and file names."""
    import datetime

    start = datetime.datetime(2024, 5, 6, 7, 8, 9)
    calls = [0]

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            calls[0] += 1
            t = start + datetime.timedelta(seconds=calls[0])
            return cls(t.year, t.month, t.day, t.hour, t.minute, t.second)

    fake = type(datetime)("datetime")
    fake.datetime = Clock
    for mod in mods:
        mod.datetime = fake


def host_view(data):
    """``environment_data`` with its Generator as the Generator's state."""
    import numpy as np

    return {k: (v.bit_generator.state if isinstance(v, np.random.Generator)
                else v) for k, v in data.items()}


def mo_shell_trace(make, device, log_dir, np, torch):
    """One seeded episode of up to SHELL_STEPS steps through the MO shell
    ``make(device, log_dir)`` with every log column and seeded Q values:
    the timesteps with environment_data and the counters after each step,
    the performance, the log files' bytes, the steps and the host seconds
    of the steps split three ways (the chain: the game's step and observe,
    the card synchronised after them; the statistics and the CSV row:
    ``_finish_timestep``; the host hooks and the fetches: the rest)."""
    from ai_safety_gridworlds_torch.mo import safety_game_mo as mo

    mo.reset_class_statics()
    ticking_clock(mo)
    env = make(device, log_dir)
    game = env._game
    split = {"chain": 0.0, "stats_csv": 0.0}

    def timed(fn, key, sync):
        def run(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return r
        return run

    game.step = timed(game.step, "chain", device != "cpu")
    game.observe = timed(game.observe, "chain", device != "cpu")
    env._finish_timestep = timed(env._finish_timestep, "stats_csv", False)
    n_dims = len(env.enabled_reward_dimension_keys)
    n_actions = game.action_max - game.action_min + 1
    rng = np.random.default_rng(SEED + 100)
    env.reset()
    trace = [env.reset()]  # the second reset opens the log
    split.update(chain=0.0, stats_csv=0.0)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHELL_STEPS):
        q = np.round(rng.normal(size=(n_actions, n_dims)) * 1e3, 7)
        env.set_current_q_value_per_action(list(q))
        ts = env.step(int(rng.integers(game.action_min, game.action_max + 1)))
        trace.append((ts, host_view(env.environment_data),
                      env.get_env_seed(), env.get_env_layout_seed(),
                      env.get_episode_no()))
        if ts.last():
            break
    seconds = time.perf_counter() - t0
    env.close()
    mo.reset_class_statics()
    files = {name: open(os.path.join(log_dir, name), "rb").read()
             for name in sorted(os.listdir(log_dir))}
    split["host"] = seconds - split["chain"] - split["stats_csv"]
    return (trace, env.get_overall_performance(), files, len(trace) - 1,
            seconds, split)


def mo_shell_phase(np, card, reset_counts, counts):
    """Phase 50: the MO shell on every configuration and experiment preset,
    on the card against the CPU."""
    import tempfile

    import torch

    from ai_safety_gridworlds_torch.experiments import presets
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.mo import safety_game_mo as mo

    columns = [getattr(mo, k) for k in dir(mo)
               if k.startswith("LOG_") and k != "LOG_COMPRESSLEVEL"]

    def shell(name, kw):
        return lambda device, log_dir: mo.SafetyEnvironmentMo(
            factory.get_raw_env(name, **kw), seed=SEED, log_columns=columns,
            log_dir=log_dir, device=device)

    def preset(name):
        return lambda device, log_dir: presets.make_experiment(
            name, seed=SEED, log_columns=columns, log_dir=log_dir,
            device=device)

    runs = [(name + "".join(f"_{k}={v}" for k, v in kw.items()),
             shell(name, kw)) for name, kw in MO_SHELL_CONFIGS]
    runs += [(f"preset_{name}", preset(name))
             for name in presets.experiment_names()]
    t_phase = time.perf_counter()
    log(f"== 50. SafetyEnvironmentMo(Game(...), seed={SEED}, "
        f"log_columns=<all {len(columns)}>, device='cuda') on "
        f"{len(MO_SHELL_CONFIGS)} configurations and "
        f"presets.make_experiment(name, ...) on "
        f"{len(presets.experiment_names())} presets: one seeded episode of "
        f"up to {SHELL_STEPS} steps each on the card, then on the CPU")
    out = {"card": card, "configs": {}}
    total_steps, total_s = 0, 0.0
    total_split = {"chain": 0.0, "host": 0.0, "stats_csv": 0.0}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, make) in enumerate(runs):
            gdir, cdir = (os.path.join(tmp, f"{i}_{w}") for w in ("card",
                                                                  "cpu"))
            gt, gperf, gfiles, gsteps, gs, gsplit = mo_shell_trace(
                make, "cuda", gdir, np, torch)
            ct, cperf, cfiles, csteps, _, _ = mo_shell_trace(
                make, "cpu", cdir, np, torch)
            if csteps != gsteps or not same_trace(ct, gt, label, np):
                fail(f"MO shell {label}: the card's episode differs from the "
                     "CPU's")
            if not same_trace(cperf, gperf, label, np):
                fail(f"MO shell {label}: performance {gperf} on the card, "
                     f"{cperf} on the CPU")
            if gfiles != cfiles or len(gfiles) != 2:
                fail(f"MO shell {label}: the card's log files "
                     f"{sorted(gfiles)} differ from the CPU's "
                     f"{sorted(cfiles)}")
            rows = sum(b.count(b"\n") for n, b in gfiles.items()
                       if n.endswith(".csv")) - 1
            if rows != gsteps:
                fail(f"MO shell {label}: {rows} CSV rows for {gsteps} steps")
            total_steps += gsteps
            total_s += gs
            for k in total_split:
                total_split[k] += gsplit[k]
            per = {k: v / gsteps * 1e3 for k, v in gsplit.items()}
            log(f"MO shell {label}: {gsteps} steps and the CSV and arguments "
                f"files equal to the CPU's, card {gs * 1e3:.1f} ms "
                f"({gsteps / gs:.0f} steps/s); per step {per['chain']:.3f} "
                f"ms chain, {per['host']:.3f} ms host hooks and fetches, "
                f"{per['stats_csv']:.3f} ms statistics and CSV row  [{card}]")
            out["configs"][label] = {"steps": gsteps,
                                     "steps_per_s": gsteps / gs,
                                     "ms_per_step": per}
    if any(counts().values()):
        fail(f"the MO shell launched a fused kernel {counts()}")
    per = {k: v / total_steps * 1e3 for k, v in total_split.items()}
    log(f"MO shell on the card: {total_steps} steps in {total_s:.2f} s, "
        f"{total_steps / total_s:.0f} steps/s over the {len(runs)} runs; "
        f"per step {per['chain']:.3f} ms chain, {per['host']:.3f} ms host "
        f"hooks and fetches, {per['stats_csv']:.3f} ms statistics and CSV "
        f"row  [{card}]")
    out["steps_per_s"] = total_steps / total_s
    out["ms_per_step"] = per
    import datetime

    mo.datetime = datetime
    log(f"phase 50: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 51: the multi-agent shell on the configurations of the JAX
# factory's _make_moma envs (helpers/factory.py:65-86) at their published
# maps -- firemaker_ex_ma (default, without the shuffle, dict actions with
# the direction and expression modalities under the relative modes),
# island_navigation_ex_ma levels 0-10 and with sustainability,
# oversatiation (level 3: no water ends the episode early) and the map
# randomized per episode, aintelope_savanna
# (default, with predators, with sustainability) -- and the 12 aintelope
# presets, with every log column: (name, env kwargs, dict actions).
MOMA_SHELL_CONFIGS = (
    ("firemaker_ex_ma", {}, False),
    ("firemaker_ex_ma", {"randomize_agent_actions_order": False}, False),
    ("firemaker_ex_ma", {"action_direction_mode": 1,
                         "observation_direction_mode": 1}, True),
) + tuple(("island_navigation_ex_ma", {"level": lv}, False)
          for lv in range(11)) + (
    ("island_navigation_ex_ma", {"level": 3,
                                 "sustainability_challenge": True}, False),
    ("island_navigation_ex_ma", {"level": 3, "penalise_oversatiation": True,
                                 "use_satiation_proportional_reward": True},
     False),
    ("island_navigation_ex_ma", {"level": 10,
                                 "map_randomization_frequency": 3}, False),
    ("aintelope_savanna", {}, False),
    ("aintelope_savanna", {"amount_agents": 2, "amount_predators": 3}, False),
    ("aintelope_savanna", {"amount_agents": 2, "amount_drink_holes": 2,
                           "sustainability_challenge": True}, False),
)


def moma_actions(env, ts, rng, dict_actions):
    """Random actions of the agents that are neither LAST nor DEAD (dicts
    with direction and expression entries when ``dict_actions``)."""
    game = env._game
    out = {}
    for a in env.agent_names:
        if int(ts.step_type[a]) >= 2:  # LAST or DEAD
            continue
        step = int(rng.integers(game.action_min, game.action_max + 1))
        if not dict_actions:
            out[a] = step
            continue
        act = {"step": step}
        if rng.random() < 0.4:
            act["action_direction"] = int(rng.integers(0, 5))
        if rng.random() < 0.4:
            act["observation_direction"] = int(rng.integers(0, 5))
        if rng.random() < 0.5:
            act["expression_smile"] = float(rng.random())
        out[a] = act
    return out


def moma_shell_trace(make, dict_actions, device, log_dir, np, torch):
    """One seeded episode of up to SHELL_STEPS steps through the
    multi-agent shell ``make(device, log_dir)`` with every log column and
    seeded per-agent Q values: the timesteps with environment_data and the
    counters after each step, the index of the first step at which a
    regrown power came within CHAIN_REGROW_GAP of an integer (None if
    none), the performance, the log files' bytes, the steps and the host
    seconds of the steps split three ways (the chain: the game's step,
    sub-step, end of step and observe, the card synchronised after them;
    the statistics and the CSV row; the host mirrors, hooks and fetches:
    the rest)."""
    from ai_safety_gridworlds_torch.ma import safety_game_moma as moma
    from ai_safety_gridworlds_torch.mo import map_randomization
    from ai_safety_gridworlds_torch.mo import safety_game_mo as mo

    mo.reset_class_statics()
    map_randomization.clear_randomization_cache()
    ticking_clock(mo, moma)
    env = make(device, log_dir)
    game = env._game
    if hasattr(game, "regrow_gaps"):
        game.regrow_gaps = []
    split = {"chain": 0.0, "stats_csv": 0.0}
    depth = [0]

    def timed(fn, key, sync):
        # The island's step calls the sub-step and the end of step: only
        # the outermost timed call counts.
        def run(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                r = fn(*a, **kw)
                if sync and depth[0] == 1:
                    torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                split[key] += time.perf_counter() - t0
            return r
        return run

    for name in ("step", "apply_substep", "finalize_step", "observe"):
        setattr(game, name, timed(getattr(game, name), "chain",
                                  device != "cpu"))
    for name in ("_attach_ma_stats", "_write_ma_log_row"):
        setattr(env, name, timed(getattr(env, name), "stats_csv", False))
    rng = np.random.default_rng(SEED + 100)
    env.reset()
    ts = env.reset()  # the second reset opens the log
    trace = [ts]
    exempt_at = None
    split.update(chain=0.0, stats_csv=0.0)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHELL_STEPS):
        env.set_current_q_value_per_action({
            a: np.round(rng.normal(size=(
                game.action_max - game.action_min + 1,
                len(env.enabled_agents_reward_dimensions[a]))) * 1e3, 7)
            for a in env.agent_names})
        acts = moma_actions(env, ts, rng, dict_actions)
        if not acts:
            break
        ts = env.step(acts)
        trace.append((ts, host_view(env.environment_data),
                      env.get_env_seed(), env.get_env_layout_seed(),
                      env.get_episode_no()))
        gaps = getattr(game, "regrow_gaps", None)
        if gaps:
            if exempt_at is None and float(
                    torch.stack(gaps).min()) <= CHAIN_REGROW_GAP:
                exempt_at = len(trace) - 1
            gaps.clear()
    seconds = time.perf_counter() - t0
    env.close()
    mo.reset_class_statics()
    files = {name: open(os.path.join(log_dir, name), "rb").read()
             for name in sorted(os.listdir(log_dir))}
    split["host"] = seconds - split["chain"] - split["stats_csv"]
    return (trace, exempt_at, env.get_overall_performance(), files,
            len(trace) - 1, seconds, split)


def moma_shell_phase(np, card, reset_counts, counts):
    """Phase 51: the multi-agent shell on its configurations and the
    aintelope presets, on the card against the CPU."""
    import datetime
    import tempfile

    import torch

    from ai_safety_gridworlds_torch.experiments import aintelope_presets
    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.ma import safety_game_moma as moma
    from ai_safety_gridworlds_torch.mo import safety_game_mo as mo

    columns = [getattr(mo, k) for k in dir(mo)
               if k.startswith("LOG_") and k != "LOG_COMPRESSLEVEL"]

    def shell(name, kw):
        return lambda device, log_dir: factory.get_environment_obj(
            name, seed=SEED, log_columns=columns, log_dir=log_dir,
            device=device, **kw)

    def preset(name):
        return lambda device, log_dir: (
            aintelope_presets.make_aintelope_experiment(
                name, seed=SEED, log_columns=columns, log_dir=log_dir,
                device=device))

    runs = [(name, name + "".join(f"_{k}={v}" for k, v in kw.items())
             + ("_dict_actions" if dict_actions else ""),
             shell(name, kw), dict_actions)
            for name, kw, dict_actions in MOMA_SHELL_CONFIGS]
    runs += [("aintelope_preset", f"preset_{name}", preset(name), False)
             for name in aintelope_presets.aintelope_experiment_names()]
    t_phase = time.perf_counter()
    log(f"== 51. SafetyEnvironmentMoMa(Game(...), seed={SEED}, "
        f"log_columns=<all {len(columns)}>, device='cuda') through "
        f"get_environment_obj on {len(MOMA_SHELL_CONFIGS)} configurations "
        "and aintelope_presets.make_aintelope_experiment(name, ...) on "
        f"{len(aintelope_presets.aintelope_experiment_names())} presets: one "
        f"seeded episode of up to {SHELL_STEPS} steps each on the card, "
        "then on the CPU")
    out = {"card": card, "configs": {}, "families": {}}
    totals = {}
    total_split = {"chain": 0.0, "host": 0.0, "stats_csv": 0.0}
    exempt_runs = 0
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (family, label, make, dict_actions) in enumerate(runs):
            gdir, cdir = (os.path.join(tmp, f"{i}_{w}") for w in ("card",
                                                                  "cpu"))
            gt, gcut, gperf, gfiles, gsteps, gs, gsplit = moma_shell_trace(
                make, dict_actions, "cuda", gdir, np, torch)
            ct, ccut, cperf, cfiles, csteps, _, _ = moma_shell_trace(
                make, dict_actions, "cpu", cdir, np, torch)
            cuts = [c for c in (gcut, ccut) if c is not None]
            if cuts:
                # The regrowth rule: compared up to the first exempt step.
                cut = min(cuts)
                exempt_runs += 1
                if not same_trace(ct[:cut], gt[:cut], label, np):
                    fail(f"MoMa shell {label}: the card's episode differs "
                         f"from the CPU's before step {cut}")
                for n in gfiles:
                    # The header and the rows of the steps before the cut.
                    keep = cut if n.endswith(".csv") else None
                    if (gfiles[n].splitlines()[:keep]
                            != cfiles.get(n, b"").splitlines()[:keep]):
                        fail(f"MoMa shell {label}: {n} differs before step "
                             f"{cut}")
            else:
                if csteps != gsteps or not same_trace(ct, gt, label, np):
                    fail(f"MoMa shell {label}: the card's episode differs "
                         "from the CPU's")
                if not same_trace(cperf, gperf, label, np):
                    fail(f"MoMa shell {label}: performance {gperf} on the "
                         f"card, {cperf} on the CPU")
                if gfiles != cfiles:
                    fail(f"MoMa shell {label}: the card's log files "
                         f"{sorted(gfiles)} differ from the CPU's "
                         f"{sorted(cfiles)}")
            if len(gfiles) != 2:
                fail(f"MoMa shell {label}: log files {sorted(gfiles)}")
            rows = sum(b.count(b"\n") for n, b in gfiles.items()
                       if n.endswith(".csv")) - 1
            if rows != gsteps:
                fail(f"MoMa shell {label}: {rows} CSV rows for {gsteps} "
                     "steps")
            fam = totals.setdefault(family, [0, 0.0])
            fam[0] += gsteps
            fam[1] += gs
            for k in total_split:
                total_split[k] += gsplit[k]
            per = {k: v / gsteps * 1e3 for k, v in gsplit.items()}
            log(f"MoMa shell {label}: {gsteps} steps and the CSV and "
                f"arguments files equal to the CPU's"
                + (f" up to step {min(cuts)} (regrowth rule)" if cuts
                   else "")
                + f", card {gs * 1e3:.1f} ms ({gsteps / gs:.0f} steps/s); "
                f"per step {per['chain']:.3f} ms chain, {per['host']:.3f} "
                f"ms host mirrors, hooks and fetches, {per['stats_csv']:.3f}"
                f" ms statistics and CSV row  [{card}]")
            out["configs"][label] = {"steps": gsteps,
                                     "steps_per_s": gsteps / gs,
                                     "ms_per_step": per}
    if any(counts().values()):
        fail(f"the MoMa shell launched a fused kernel {counts()}")
    for family, (steps, seconds) in totals.items():
        log(f"MoMa shell {family}: {steps} steps in {seconds:.2f} s, "
            f"{steps / seconds:.0f} steps/s  [{card}]")
        out["families"][family] = {"steps": steps,
                                   "steps_per_s": steps / seconds}
    total_steps = sum(s for s, _ in totals.values())
    total_s = sum(s for _, s in totals.values())
    per = {k: v / total_steps * 1e3 for k, v in total_split.items()}
    log(f"MoMa shell on the card: {total_steps} steps in {total_s:.2f} s, "
        f"{total_steps / total_s:.0f} steps/s over the {len(runs)} runs "
        f"({exempt_runs} cut by the regrowth rule); per step "
        f"{per['chain']:.3f} ms chain, {per['host']:.3f} ms host mirrors, "
        f"hooks and fetches, {per['stats_csv']:.3f} ms statistics and CSV "
        f"row  [{card}]")
    out["steps_per_s"] = total_steps / total_s
    out["ms_per_step"] = per
    out["exempt_runs"] = exempt_runs
    mo.datetime = datetime
    moma.datetime = datetime
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 51: {out['seconds']:.1f} s")
    return out


# Phase 52: the Gym and PettingZoo adapters over the three shells on the
# card, each run against the same run on the CPU. The options of
# GridworldGymEnv spread over the 47 names by their index (a shell whose
# observation lacks the ASCII board or the layers a set reads takes
# transitions with flattening instead);
# the multi-agent names are driven as a single agent (firemaker_ex_ma as
# its supervisor).
ADAPTER_STEPS = 30
GYM_OPTION_SETS = (
    ("plain", {}),
    ("transitions", {"use_transitions": True}),
    ("flatten", {"flatten_observations": True}),
    ("ascii", {"ascii_observation_format": True}),
    ("multi_discrete", {"use_multi_discrete_action_space": True}),
    ("coordinates", {"object_coordinates_in_observation": True}),
    ("cube", {"layers_order_in_cube": []}),
)
# The multi-agent configurations of tests/test_zoo_conformance.py, two
# aintelope presets, and island_navigation_ex_ma with test_death.
ZOO_CONFIGS = (
    ("island_navigation_ex_ma", {"level": 9, "amount_agents": 2}),
    ("firemaker_ex_ma", {"amount_agents": 2}),
    ("aintelope_savanna", {"level": 13, "amount_agents": 2}),
    ("food_sharing", {}),
    ("food_drink_homeostasis_gold", {}),
    ("island_navigation_ex_ma", {"level": 9, "test_death": True,
                                 "test_death_probability": 0.2}),
)
ZOO_STEPS = 15
AEC_TURNS = 40
# The names whose repeated same-seed resets differ by design (the
# class-wide trial and episode counters, the savanna's per-episode maps):
# gymnasium's checker must fail them on its determinism check alone (the
# JAX package's tests/test_adapter_conformance.py holds the same set).
TRIAL_COUNTER_NONDETERMINISTIC = {
    "aintelope_savanna", "danger_tiles", "food_drink_homeostasis",
    "food_drink_homeostasis_danger_gold_silver",
    "food_drink_homeostasis_gold", "food_drink_homeostasis_gold_silver",
    "food_drink_homeostasis_predators_gold_silver", "food_homeostasis",
    "food_sharing", "food_sustainability", "food_unbounded", "predators",
    "safe_interruptibility_ex", "savanna_demo",
}


def gym_options(name, index):
    """The option set of name ``index`` of the 47 (see GYM_OPTION_SETS);
    where the shell's observation has no ASCII board or no layers for the
    set to read, transitions with flattening instead."""
    from ai_safety_gridworlds_torch.helpers import factory

    label, kw = GYM_OPTION_SETS[index % len(GYM_OPTION_SETS)]
    needs = {"ascii": "ascii", "coordinates": "layers", "cube": "layers"}
    if label in needs:
        spec = factory.get_environment_obj(name,
                                           device="cpu").observation_spec()
        if needs[label] not in spec:
            label, kw = "transitions_flatten", {"use_transitions": True,
                                                "flatten_observations": True}
    if name == "firemaker_ex_ma":
        label, kw = label + "_supervisor", dict(kw, agent_character="S")
    return label, kw


class AdapterClock:
    """Host seconds of an adapter's steps and of its shell's steps within
    them; the regrowth rule's first exempt entry of the trace."""

    def __init__(self, adapter, torch):
        self.adapter_s = self.shell_s = 0.0
        self.steps = 0
        self.exempt_at = None
        self._torch = torch
        shell = adapter._env
        self._game = shell._game
        if hasattr(self._game, "regrow_gaps"):
            self._game.regrow_gaps = []
        step = shell.step

        def timed(*a, **kw):
            t0 = time.perf_counter()
            r = step(*a, **kw)
            self.shell_s += time.perf_counter() - t0
            return r

        shell.step = timed

    def step(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.adapter_s += time.perf_counter() - t0
        self.steps += 1
        return out

    def note(self, trace):
        gaps = getattr(self._game, "regrow_gaps", None)
        if gaps:
            if self.exempt_at is None and float(
                    self._torch.stack(gaps).min()) <= CHAIN_REGROW_GAP:
                self.exempt_at = len(trace) - 1
            gaps.clear()


def fresh_shell_statics():
    from ai_safety_gridworlds_torch.mo import map_randomization
    from ai_safety_gridworlds_torch.mo import safety_game_mo as mo

    mo.reset_class_statics()
    map_randomization.clear_randomization_cache()


def gym_adapter_trace(name, kw, device, np, torch):
    """One seeded episode of up to ADAPTER_STEPS steps through
    GridworldGymEnv(name, device=device, **kw), actions sampled from the
    seeded action space: every step's outputs with the ansi and rgb
    renders, and the adapter's clock."""
    from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
        GridworldGymEnv,
    )

    fresh_shell_statics()
    np.random.seed(SEED)
    env = GridworldGymEnv(name, device=device, **kw)
    clock = AdapterClock(env, torch)
    trace = [env.reset(seed=SEED)]
    env.action_space.seed(SEED)
    for _ in range(ADAPTER_STEPS):
        out = clock.step(env.step, env.action_space.sample())
        trace.append((out, env.render("ansi"), env.render("rgb_array")))
        clock.note(trace)
        if out[2]:
            break
    env.close()
    return trace, clock


def zoo_adapter_traces(name, kw, device, np, torch):
    """ZOO_STEPS seeded steps through GridworldZooParallelEnv and AEC_TURNS
    turns through GridworldZooAecEnv (``scalarise=True``, as PettingZoo's
    API test asks), actions sampled from the seeded spaces: two traces
    and their clocks."""
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_aec_env import (
        GridworldZooAecEnv,
    )
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_parallel_env import (
        GridworldZooParallelEnv,
    )

    fresh_shell_statics()
    np.random.seed(SEED)
    env = GridworldZooParallelEnv(name, device=device, **kw)
    pclock = AdapterClock(env, torch)
    ptrace = [env.reset(seed=SEED)]
    for i, a in enumerate(env.possible_agents):
        env.action_space(a).seed(SEED + i)
    for _ in range(ZOO_STEPS):
        if not env.agents:
            break
        actions = {a: env.action_space(a).sample() for a in env.agents}
        ptrace.append((pclock.step(env.step, actions), list(env.agents),
                       env.render("ansi")))
        pclock.note(ptrace)
    fresh_shell_statics()
    np.random.seed(SEED)
    env = GridworldZooAecEnv(name, device=device, scalarise=True, **kw)
    aclock = AdapterClock(env, torch)
    env.reset(seed=SEED)
    space = env.action_space(env.possible_agents[0])
    space.seed(SEED)
    atrace = [env.agent_selection]
    for agent in env.agent_iter(max_iter=AEC_TURNS):
        obs, reward, term, trunc, info = env.last()
        action = None if term or trunc else space.sample()
        aclock.step(env.step, action)
        atrace.append((agent, obs, reward, term, trunc, info,
                       dict(env.rewards), list(env.agents)))
        aclock.note(atrace)
    return ptrace, pclock, atrace, aclock


def compare_runs(label, card, cpu, np):
    """The card's trace against the CPU's, up to the first entry either run
    exempts by the regrowth rule (phase 51's rule); the exempt entry's
    index or None."""
    (gt, gclock), (ct, cclock) = card, cpu
    cuts = [c.exempt_at for c in (gclock, cclock) if c.exempt_at is not None]
    cut = min(cuts) if cuts else None
    if cut is None and len(gt) != len(ct):
        fail(f"adapters {label}: {len(gt)} entries on the card, {len(ct)} on "
             "the CPU")
    if not same_trace(ct[:cut], gt[:cut], label, np):
        fail(f"adapters {label}: the card's run differs from the CPU's"
             + (f" before entry {cut}" if cut is not None else ""))
    return cut


def adapter_rates(clock):
    """Steps/s of the adapter and its own host ms a step (the adapter's
    step minus the shell's)."""
    return {"steps": clock.steps,
            "steps_per_s": clock.steps / clock.adapter_s,
            "adapter_ms_per_step": (clock.adapter_s - clock.shell_s)
            / clock.steps * 1e3,
            "shell_ms_per_step": clock.shell_s / clock.steps * 1e3}


def replay_demonstrations(np, card):
    """Every demonstration through GridworldGymEnv on the card: its exact
    return, safety performance and termination."""
    from ai_safety_gridworlds_torch.demonstrations import demonstrations
    from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
        INFO_HIDDEN_REWARD,
        GridworldGymEnv,
    )

    out = {}
    for name in sorted(demonstrations.environment_names()):
        for i, demo in enumerate(demonstrations.get_demonstrations(name)):
            fresh_shell_statics()
            np.random.seed(demo.seed)
            env = GridworldGymEnv(name, device="cuda")
            env.reset()
            ret = hidden = 0
            done = False
            for action in demo.actions:
                _, reward, done, _, info = env.step(int(action))
                ret += reward
                if info[INFO_HIDDEN_REWARD] is not None:
                    hidden += info[INFO_HIDDEN_REWARD]
            live = env._env._get_hidden_reward(default_reward=None)
            perf = env._env.get_overall_performance()
            if (ret != demo.episode_return or done != demo.terminates
                    or (live is not None
                        and hidden != demo.safety_performance)
                    or (demo.terminates
                        and perf != demo.safety_performance)):
                fail(f"demonstration {name}[{i}]: return {ret}, hidden "
                     f"{hidden}, performance {perf}, done {done} against "
                     f"{demo}")
            out[f"{name}[{i}]"] = {"steps": len(demo.actions),
                                   "return": ret, "performance": perf}
            log(f"demonstration {name}[{i}]: {len(demo.actions)} steps, "
                f"return {ret}, safety performance {perf}, terminates "
                f"{done}, exact  [{card}]")
    return out


def official_checkers(np, card):
    """gymnasium's register_with_gym, gym.make and check_env, and
    PettingZoo's parallel_api_test and api_test, on the card where the
    libraries are installed; null with the reason where they are not."""
    import warnings

    from ai_safety_gridworlds_torch.helpers import factory
    from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
        GridworldGymEnv,
    )
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_aec_env import (
        GridworldZooAecEnv,
    )
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_parallel_env import (
        GridworldZooParallelEnv,
    )

    out = {}
    try:
        import gymnasium
        from gymnasium.utils.env_checker import check_env
    except ImportError as e:
        out["gymnasium"] = None
        out["gymnasium_reason"] = f"not run: gymnasium does not import ({e})"
        log(f"gymnasium checks not run: gymnasium does not import ({e})")
    else:
        factory.register_with_gym()
        env = gymnasium.make("ai_safety_gridworlds.boat_race-v0",
                             device="cuda")
        env.reset(seed=SEED)
        _, reward, *_ = env.step(4)
        if reward != 2.0:
            fail(f"gym.make's boat_race gave reward {reward} for RIGHT")
        failures = {}
        for name in factory.env_names():
            fresh_shell_statics()
            np.random.seed(SEED)
            env = GridworldGymEnv(name, device="cuda")
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore")
                try:
                    check_env(env, skip_render_check=True)
                except AssertionError as e:
                    failures[name] = str(e)
        wrong = {n: m for n, m in failures.items()
                 if n not in TRIAL_COUNTER_NONDETERMINISTIC
                 or "Deterministic step" not in m}
        missing = TRIAL_COUNTER_NONDETERMINISTIC - set(failures)
        if wrong or missing:
            fail(f"check_env: unexpected failures {wrong}, missing {missing}")
        out["gymnasium"] = {"version": gymnasium.__version__,
                            "check_env_names": len(factory.env_names()),
                            "determinism_exceptions": len(failures)}
        log(f"gymnasium {gymnasium.__version__}: gym.make, and check_env "
            f"on {len(factory.env_names())} names, {len(failures)} failing "
            f"only the determinism check as expected  [{card}]")
    try:
        from pettingzoo.test import api_test, parallel_api_test
    except ImportError as e:
        out["pettingzoo"] = None
        out["pettingzoo_reason"] = f"not run: pettingzoo does not import ({e})"
        log(f"PettingZoo checks not run: pettingzoo does not import ({e})")
    else:
        import pettingzoo

        for name, kw in ZOO_CONFIGS[:3]:
            fresh_shell_statics()
            parallel_api_test(GridworldZooParallelEnv(name, device="cuda",
                                                      **kw), num_cycles=30)
            fresh_shell_statics()
            api_test(GridworldZooAecEnv(name, device="cuda", scalarise=True,
                                        **kw), num_cycles=30)
        out["pettingzoo"] = {"version": pettingzoo.__version__,
                             "configs": 3}
        log(f"pettingzoo {pettingzoo.__version__}: parallel_api_test and "
            f"api_test on 3 configurations  [{card}]")
    return out


def pickle_round_trips(np, card):
    """One adapter per shell and adapter family pickled on the card: the
    copy's next steps equal the original's."""
    import pickle

    from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
        GridworldGymEnv,
    )
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_aec_env import (
        GridworldZooAecEnv,
    )
    from ai_safety_gridworlds_torch.helpers.gridworld_zoo_parallel_env import (
        GridworldZooParallelEnv,
    )

    def gym_steps(env):
        out = []
        for k in (1, 2, 3, 4, 2):
            out.append(env.step(k))
            if out[-1][2]:
                break
        return out

    def parallel_steps(env):
        return [env.step({a: k for a in env.agents}) for k in (1, 2, 3, 0)]

    def aec_steps(env):
        out = []
        for k in (1, 2, 3, 4, 0, 1):
            if env.agent_selection is None:
                break
            _, _, term, trunc, _ = env.last()
            env.step(None if term or trunc else k)
            out.append(env.last())
        return out

    cases = (
        ("gym_scalar", lambda: GridworldGymEnv("boat_race", device="cuda"),
         gym_steps),
        ("gym_mo", lambda: GridworldGymEnv("island_navigation_ex",
                                           device="cuda"), gym_steps),
        ("gym_moma", lambda: GridworldGymEnv("aintelope_savanna",
                                             amount_agents=2, level=13,
                                             device="cuda"), gym_steps),
        ("parallel_moma", lambda: GridworldZooParallelEnv(
            "firemaker_ex_ma", device="cuda"), parallel_steps),
        ("aec_moma", lambda: GridworldZooAecEnv(
            "aintelope_savanna", amount_agents=2, level=13, device="cuda"),
         aec_steps),
    )
    done = []
    for label, make, steps in cases:
        fresh_shell_statics()
        env = make()
        env.reset(seed=SEED)
        steps(env)
        rng = np.random.get_state()
        twin = pickle.loads(pickle.dumps(env))
        np.random.set_state(rng)
        a = steps(env)
        np.random.set_state(rng)
        b = steps(twin)
        if not same_trace(a, b, label, np):
            fail(f"adapters {label}: the unpickled copy steps otherwise")
        done.append(label)
    log(f"pickle round trips on the card: {done}, each copy stepping as its "
        f"original  [{card}]")
    return done


def viewer_frames(device, np):
    """A headless AgentViewer's frames on a frozen clock through a few
    firemaker_ex_ma steps."""
    import types

    from ai_safety_gridworlds_torch.helpers import agent_viewer
    from ai_safety_gridworlds_torch.helpers import factory

    clock = agent_viewer.time
    agent_viewer.time = types.SimpleNamespace(time=lambda: 1000.0,
                                              sleep=lambda s: None)
    try:
        fresh_shell_statics()
        np.random.seed(SEED)
        env = factory.get_environment_obj("firemaker_ex_ma", device=device)
        viewer = agent_viewer.AgentViewer(pause=0.0, headless=True)
        ts = env.reset()
        frames = [viewer.render(env, ts)]
        for k in (2, 4, 1):
            ts = env.step({a: k for a in env.agent_names})
            viewer.display(env, ts)
            frames.append(list(viewer.last_frame))
    finally:
        agent_viewer.time = clock
    return frames


def adapter_phase(np, card, reset_counts, counts):
    """Phase 52: the Gym and PettingZoo adapters, the demonstrations, the
    official checkers, pickling and the viewer on the card."""
    import torch

    from ai_safety_gridworlds_torch.helpers import factory

    t_phase = time.perf_counter()
    names = factory.env_names()
    log(f"== 52. the adapters on the card against the CPU: GridworldGymEnv "
        f"on {len(names)} names (one seeded episode of up to {ADAPTER_STEPS} "
        f"steps each, options spread over them), GridworldZooParallelEnv "
        f"({ZOO_STEPS} steps) and GridworldZooAecEnv ({AEC_TURNS} turns) on "
        f"{len(ZOO_CONFIGS)} configurations, the demonstrations, the "
        "official checkers, pickling and the viewer")
    out = {"card": card, "libraries": {}}
    for lib in ("gymnasium", "gym", "pettingzoo"):
        try:
            mod = __import__(lib)
            out["libraries"][lib] = getattr(mod, "__version__", "?")
        except ImportError:
            out["libraries"][lib] = None
    from ai_safety_gridworlds_torch.helpers import _spaces

    out["spaces"] = _spaces.Box.__module__
    log(f"libraries on this host: {out['libraries']}; the adapters' spaces "
        f"come from {out['spaces']}")
    reset_counts()
    out["demonstrations"] = replay_demonstrations(np, card)

    out["gym"] = {}
    exempt = 0
    clocks = []
    for i, name in enumerate(names):
        label, kw = gym_options(name, i)
        key = f"{name}/{label}"
        card_run = gym_adapter_trace(name, kw, "cuda", np, torch)
        cpu_run = gym_adapter_trace(name, kw, "cpu", np, torch)
        cut = compare_runs(key, card_run, cpu_run, np)
        exempt += cut is not None
        clock = card_run[1]
        clocks.append(clock)
        out["gym"][key] = adapter_rates(clock)
        rate = out["gym"][key]
        log(f"gym {key}: {clock.steps} steps equal to the CPU's"
            + (f" up to entry {cut} (regrowth rule)" if cut is not None
               else "")
            + f", {rate['steps_per_s']:.0f} steps/s, adapter "
            f"{rate['adapter_ms_per_step']:.3f} ms + shell "
            f"{rate['shell_ms_per_step']:.3f} ms a step  [{card}]")

    out["parallel"], out["aec"] = {}, {}
    pclocks, aclocks = [], []
    for name, kw in ZOO_CONFIGS:
        key = name + "".join(f"_{k}={v}" for k, v in kw.items())
        gp, gpc, ga, gac = zoo_adapter_traces(name, kw, "cuda", np, torch)
        cp, cpc, ca, cac = zoo_adapter_traces(name, kw, "cpu", np, torch)
        for kind, card_run, cpu_run, store, clocks_ in (
                ("parallel", (gp, gpc), (cp, cpc), out["parallel"], pclocks),
                ("aec", (ga, gac), (ca, cac), out["aec"], aclocks)):
            cut = compare_runs(f"{kind} {key}", card_run, cpu_run, np)
            exempt += cut is not None
            clocks_.append(card_run[1])
            store[key] = adapter_rates(card_run[1])
            rate = store[key]
            log(f"{kind} {key}: {card_run[1].steps} steps equal to the "
                f"CPU's" + (f" up to entry {cut} (regrowth rule)"
                            if cut is not None else "")
                + f", {rate['steps_per_s']:.0f} steps/s, adapter "
                f"{rate['adapter_ms_per_step']:.3f} ms + shell "
                f"{rate['shell_ms_per_step']:.3f} ms a step  [{card}]")
    if "test_death" not in str(out["parallel"]):
        fail("no test_death run")

    out["checkers"] = official_checkers(np, card)
    out["pickle"] = pickle_round_trips(np, card)
    gframes, cframes = viewer_frames("cuda", np), viewer_frames("cpu", np)
    if gframes != cframes:
        fail("the headless viewer's frames on the card differ from the CPU's")
    out["viewer_frames"] = len(gframes)
    log(f"headless AgentViewer: {len(gframes)} frames equal to the CPU's")
    launches = counts()
    if any(launches.values()):
        fail(f"the adapters launched a fused kernel {launches}")
    for kind, cl in (("gym", clocks), ("parallel", pclocks),
                     ("aec", aclocks)):
        steps = sum(c.steps for c in cl)
        total = sum(c.adapter_s for c in cl)
        shell = sum(c.shell_s for c in cl)
        out[f"{kind}_steps_per_s"] = steps / total
        out[f"{kind}_adapter_ms_per_step"] = (total - shell) / steps * 1e3
        out[f"{kind}_adapter_share"] = (total - shell) / total
        log(f"{kind} overall: {steps} steps in {total:.2f} s, "
            f"{steps / total:.0f} steps/s; the adapter's own host time "
            f"{(total - shell) / steps * 1e3:.3f} ms a step, "
            f"{(total - shell) / total:.2%} of a step  [{card}]")
    out["exempt_runs"] = exempt
    out["fused_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 52: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------- 53. scale-out

# Each rank process of phase 53 must end within this many seconds (a world
# takes 20-50 s on an H100), so that a hung rendezvous fails the run well
# within its time limit.
SCALEOUT_TIMEOUT_S = 150
# The K3, K5 and K9 two-rank steps run at this batch.
SCALEOUT_SMALL_BATCH = 256
# Timed steps of each kind on the one-rank NCCL mesh.
SCALEOUT_TIMED = 3
# The A2C step under the (1, 2) mesh: lanes, hidden units and unrolled
# steps (__graft_entry__.dryrun_multichip's hidden and unroll, more lanes).
A2C_MESH_BATCH, A2C_MESH_HIDDEN, A2C_MESH_STEPS, A2C_MESH_LR = 1024, 128, 4, 1e-3
# measure_steps_per_second on generic boat_race: steps a chunk and reps.
PROFILE_STEPS, PROFILE_REPS, LATENCY_STEPS = 128, 3, 100
# The collection kernels a profiled fused train_step should show.
TRACE_PATHS = (
    ("K3", "firemaker_ex_ma", "fm_collect_kernel"),
    ("K5", "boat_race", "sc_collect_kernel"),
    ("K7", "island_navigation_ex_ma", "im_collect_kernel"),
    ("K9", "aintelope_savanna", "sv_collect_kernel"),
)


def kernel_wrappers():
    """The launch-counting wrappers of K1 and K3-K9."""
    from ai_safety_gridworlds_torch.ops import (
        fused_firemaker,
        fused_island_ma,
        fused_savanna,
        fused_scalar,
    )

    return (fused_firemaker.fused_firemaker_rollout,
            fused_firemaker.fused_firemaker_collect,
            fused_scalar.fused_scalar_rollout,
            fused_scalar.fused_scalar_collect,
            fused_island_ma.fused_island_ma_rollout,
            fused_island_ma.fused_island_ma_collect,
            fused_savanna.fused_savanna_rollout,
            fused_savanna.fused_savanna_collect)


class LaunchTally:
    """Launches of each kernel wrapper made inside ``with tally:`` blocks,
    summed over the blocks (the sharded paths' launches; launches made to
    compare with unsharded or plain runs fall outside them)."""

    def __init__(self):
        self.wrappers = kernel_wrappers()
        self.counts = {w.__name__: 0 for w in self.wrappers}

    def __enter__(self):
        self.before = {w.__name__: w.launches for w in self.wrappers}
        return self

    def __exit__(self, *exc):
        for w in self.wrappers:
            self.counts[w.__name__] += w.launches - self.before[w.__name__]
        return False


def states_equal(a, b, fields, lanes=None):
    """Names of ``fields`` whose tensors differ (on the ``lanes`` mask of the
    last axis, if given)."""
    import torch

    bad = []
    for k in fields:
        x, y = a[k], b[k].to(a[k].device)
        if not x.is_floating_point():
            x, y = x.to(torch.int64), y.to(torch.int64)
        if lanes is not None:
            x, y = x[..., lanes], y[..., lanes]
        if not torch.equal(x, y):
            bad.append(k)
    return bad


def train_states_equal(a, b):
    """Names of the params, Adam state entries and packed-state fields in
    which two fused-PPO states differ."""
    import torch

    bad = states_equal(a.S, b.S, a.S)
    for k, p in a.params.items():
        q = b.params[k]
        if not torch.equal(p.detach(), q.detach().to(p.device)):
            bad.append(k)
        sa, sb = a.opt.state[p], b.opt.state[q]
        bad += [f"{k}.{n}" for n in sa
                if not torch.equal(sa[n], sb[n].to(sa[n].device))]
    return bad


def near_cdf_lanes(fused, S, params, n_steps, torch):
    """Bool [lanes]: lanes of a plain collection from ``S`` under ``params``
    with a draw within CDF_GAP of a cumulative softmax sum (phase 7's
    exemption)."""
    statics = fused._collect_statics(S, params)
    near = torch.zeros(S["t"].shape[1], dtype=torch.bool, device=S["t"].device)
    for _ in range(n_steps):
        S, _, ex = fused._collect_step(S, statics)
        near |= (ex["pol"]["cdf_gap"] < CDF_GAP).any(dim=0)
    return near


def scaleout_train_engines(batch):
    """(label, kernel, fused engine) of the two-rank PPO steps held against
    the CPU: island_navigation_ex_ma at ``BATCH`` (bench.py:533-560's
    configuration), firemaker_ex_ma, boat_race and aintelope_savanna at
    ``batch``."""
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna
    from ai_safety_gridworlds_torch.ops.fused_scalar import FusedBoatRace

    return (
        ("island", "K7", FusedIslandMa(IslandNavigationExMa()), BATCH),
        ("firemaker", "K3", FusedFiremaker(FiremakerExMa()), batch),
        ("boat_race", "K5", FusedBoatRace(BoatRace()), batch),
        ("savanna", "K9", FusedSavanna(AIntelopeSavanna()), batch),
    )


def collectives_ms(mesh, state, n_metrics, cfg, torch):
    """CUDA-event ms of one sharded train_step's collectives on ``mesh``:
    an all-reduce (mean) of the flat gradient buffer per minibatch update
    and one of the metrics, on card tensors; and the buffer's floats."""
    from ai_safety_gridworlds_torch.parallel.mesh import all_reduce

    grads = torch.zeros(sum(p.numel() for p in state.params.values()),
                        device=mesh.device)
    means = torch.zeros(n_metrics, device=mesh.device)

    def collectives():
        for _ in range(cfg.n_epochs * cfg.n_minibatches):
            all_reduce(grads, mesh, mean=True)
        all_reduce(means, mesh, mean=True)

    return cuda_ms(collectives, 5, torch), grads.numel()


def scaleout_world1(torch, np, mesh, tally):
    """Phase 53 on the one-rank NCCL mesh: the sharded K1 rollout against
    BatchedEnv's unsharded run, and the sharded island PPO step against
    make_train_step, bit for bit, timed against it with the collectives'
    share."""
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops.fused_base import shard_statics
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa

    dev = mesh.device
    out = {}
    env = BatchedEnv("firemaker_ex_ma", batch_size=BATCH, seed=SEED,
                     device="cuda")
    fused = env.fused
    S0 = {k: v.clone() for k, v in env.state.items()}
    env.rollout(MAIN_STEPS)
    lo, hi = mesh.lanes(BATCH)
    with tally:
        Sk = fused.rollout({k: v[:, lo:hi].contiguous() for k, v in S0.items()},
                           MAIN_STEPS,
                           statics=shard_statics(fused.statics_on(dev), lo, hi))
        torch.cuda.synchronize()
    bad = states_equal(Sk, {k: v[:, lo:hi] for k, v in env.state.items()},
                       fused.STATE_FIELDS)
    if bad:
        fail(f"world 1: the sharded K1 rollout differs in {bad}")
    out["k1_rollout_equal"] = True

    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    fused = FusedIslandMa(IslandNavigationExMa())
    a = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                   device="cuda")
    b = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                   device="cuda")
    step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    sharded, shard_state = ppo_fused.make_sharded_train_step(fused, mesh, cfg)
    b = shard_state(b)
    for _ in range(2):
        a, _ = step(a)
        with tally:
            b, metrics = sharded(b)
    torch.cuda.synchronize()
    bad = train_states_equal(a, b)
    if bad:
        fail(f"world 1: the sharded island step differs from make_train_step "
             f"in {bad}")
    out["k7_train_equal"] = True

    def timed(fn, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3

    plain_ms, sharded_ms = [], []
    for _ in range(SCALEOUT_TIMED):
        a, ms = timed(step, a)
        plain_ms.append(ms)
        with tally:
            b, ms = timed(sharded, b)
        sharded_ms.append(ms)
    coll_ms, floats = collectives_ms(mesh, b, len(metrics), cfg, torch)
    med = sorted(sharded_ms)[len(sharded_ms) // 2]
    out.update({
        "train_step_ms": plain_ms, "sharded_train_step_ms": sharded_ms,
        "collectives_ms": coll_ms, "collectives_share": coll_ms / med,
        "grad_buffer_floats": floats,
        "all_reduces_a_step": cfg.n_epochs * cfg.n_minibatches + 1,
    })
    return out


def scaleout_world2(torch, np, mesh, rank, out_dir, tally):
    """Phase 53 on two gloo ranks sharing the card: the sharded K1, K6 and K8
    rollouts against the unsharded kernels, bit for bit; the two-rank PPO
    steps on K7, K3, K5 and K9 against the same two-rank steps on the CPU;
    A2C under a (1, 2) mesh against one process's step; a sharded
    checkpoint round trip of the island PPO state."""
    import copy

    from ai_safety_gridworlds_torch.core import base, threefry
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.learners import actor_critic as ac
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops.fused_base import shard_statics
    from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna
    from ai_safety_gridworlds_torch.parallel.mesh import make_mesh
    from ai_safety_gridworlds_torch.utils import checkpoint

    dev = mesh.device
    out = {"rollouts": {}, "train": {}}
    pool = {"map_randomization_frequency": 1, "max_iterations": 20}
    for label, fused, K in (
            ("K1 firemaker", FusedFiremaker(FiremakerExMa()), 1),
            ("K6 island", FusedIslandMa(IslandNavigationExMa()), 1),
            ("K6 island pool3", FusedIslandMa(IslandNavigationExMa(**pool)), 3),
            ("K8 savanna", FusedSavanna(AIntelopeSavanna()), 1),
            ("K8 savanna pool3",
             FusedSavanna(AIntelopeSavanna(map_randomization_frequency=1)), 3)):
        kw = {"layout_pool": K} if K > 1 else {}
        S0 = fused.init_packed(SEED, BATCH, dev, **kw)
        ref = fused.rollout(S0, MAIN_STEPS)
        lo, hi = mesh.lanes(BATCH)
        with tally:
            Sk = fused.rollout(
                {k: v[:, lo:hi].contiguous() for k, v in S0.items()},
                MAIN_STEPS,
                statics=shard_statics(fused.statics_on(dev), lo, hi))
            torch.cuda.synchronize()
        bad = states_equal(Sk, {k: v[:, lo:hi] for k, v in ref.items()},
                           fused.STATE_FIELDS)
        if bad:
            fail(f"world 2 rank {rank}: the sharded {label} rollout differs "
                 f"in {bad}")
        out["rollouts"][label] = {
            "lanes": [lo, hi], "episodes": int(Sk["stats_episodes"].sum()),
            "per_lane_statics": sorted(
                k for k, v in fused.statics_on(dev).items() if v.shape[1] > 1),
        }

    cpu_mesh = make_mesh(device="cpu")
    for label, kernel, fused, batch in scaleout_train_engines(
            SCALEOUT_SMALL_BATCH):
        cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                       n_minibatches=4, hidden=HIDDEN)
        card = ppo_fused.init_train_state(fused, batch, seed=SEED, config=cfg,
                                          device="cuda")
        host = ppo_fused.init_train_state(fused, batch, seed=SEED, config=cfg,
                                          device="cpu")
        c_step, c_shard = ppo_fused.make_sharded_train_step(fused, mesh, cfg)
        h_step, h_shard = ppo_fused.make_sharded_train_step(fused, cpu_mesh,
                                                            cfg)
        card, host = c_shard(card), h_shard(host)
        near = near_cdf_lanes(fused, host.S, host.params, cfg.n_steps, torch)
        if label == "island":
            template = copy.deepcopy(card)
        t0 = time.perf_counter()
        with tally:
            card, m_card = c_step(card)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, m_host = h_step(host)
        host_s = time.perf_counter() - t0
        lanes = host.S["t"].shape[1]
        keep = ~near
        differ = torch.zeros(lanes, dtype=torch.bool)
        for k in fused.STATE_FIELDS:
            x, y = card.S[k].cpu(), host.S[k]
            if not x.is_floating_point():
                x, y = x.to(torch.int64), y.to(torch.int64)
            differ |= (x != y).any(dim=0)
        diverged = int((differ & keep).sum())
        if diverged > MAX_DIVERGED_SHARE * lanes:
            fail(f"world 2 rank {rank} {label}: {diverged} non-exempt lanes "
                 "differ from the CPU's two-rank step")
        lr_bound = 2 * cfg.lr * cfg.n_epochs * cfg.n_minibatches
        p_err = max(float((card.params[k].detach().cpu()
                           - host.params[k].detach()).abs().max())
                    for k in card.params)
        if p_err > lr_bound:
            fail(f"world 2 rank {rank} {label}: params {p_err} from the "
                 f"CPU's, beyond 2 * lr per update ({lr_bound})")
        # The collection kernels' logp and value meet the plain version's
        # within FLOAT_TOL (phase 7), which the losses carry.
        m_err = {k: abs(float(m_card[k]) - float(m_host[k])) for k in m_host}
        over = {k: (float(m_card[k]), float(m_host[k])) for k in m_host
                if m_err[k] > LEARNER_RTOL * abs(float(m_host[k])) + FLOAT_TOL}
        if not near.any() and over:
            fail(f"world 2 rank {rank} {label}: metrics (card, CPU) {over} "
                 f"beyond rtol {LEARNER_RTOL} + {FLOAT_TOL}")
        out["train"][label] = {
            "kernel": kernel, "batch": batch, "exempt_lanes": int(near.sum()),
            "exempt_differing": int((differ & near).sum()),
            "diverged_lanes": diverged, "params_max_abs_err": p_err,
            "metrics_max_abs_err": max(m_err.values()),
            "card_step_ms": card_s * 1e3, "cpu_step_ms": host_s * 1e3,
        }
        if label == "island":
            ckpt_dir = os.path.join(out_dir, "ckpt")
            with checkpoint.CheckpointManager(ckpt_dir) as mgr:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(1, card)
                save_ms = (time.perf_counter() - t0) * 1e3
                step_dir = os.path.join(ckpt_dir, "1")
                nbytes = os.path.getsize(
                    os.path.join(step_dir, f"shard{rank}.pt"))
                straight, _ = c_step(card)
                t0 = time.perf_counter()
                restored = mgr.restore(1, template)
                torch.cuda.synchronize()
                restore_ms = (time.perf_counter() - t0) * 1e3
            resumed, _ = c_step(restored)
            bad = train_states_equal(straight, resumed)
            if bad:
                fail(f"world 2 rank {rank}: the resumed island step differs "
                     f"in {bad}")
            out["checkpoint"] = {"bytes": nbytes, "save_ms": save_ms,
                                 "restore_ms": restore_ms, "bit_exact": True}
            # The compared step above is the process's first: time a warm
            # one, and the step's collectives alone (through the host).
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed, _ = c_step(resumed)
            torch.cuda.synchronize()
            out["train"][label]["warm_card_step_ms"] = (
                time.perf_counter() - t0) * 1e3
            coll, _ = collectives_ms(mesh, resumed, len(m_card), cfg, torch)
            out["train"][label]["collectives_ms"] = coll

    a2c = make_mesh(n_data=1, n_model=2, device="cuda")
    env = IslandNavigation()
    params = ac.init_params(1, 48, env.action_max - env.action_min + 1,
                            hidden=A2C_MESH_HIDDEN, device="cuda")
    keys = threefry.split(threefry.PRNGKey(2, dev), A2C_MESH_BATCH)
    gaps = []
    whole, _, loss = ac.train_step(params, env, base.episode_reset(env, keys),
                                   3, lr=A2C_MESH_LR, n_steps=A2C_MESH_STEPS,
                                   draw_gaps=gaps)
    local, _, loss_m = ac.train_step(
        ac.shard_params(params, a2c), env, base.episode_reset(env, keys), 3,
        lr=A2C_MESH_LR, n_steps=A2C_MESH_STEPS, mesh=a2c)
    if float(torch.stack(gaps).min()) < LEARNER_GAP:
        fail("world 2: an A2C draw came within the near-tie gap; pick "
             "another key")
    want = ac.shard_params(whole, a2c)
    errs = {}
    for f in ac.ACParams._fields:
        g = (getattr(params, f) - getattr(whole, f)).detach() / A2C_MESH_LR
        bound = A2C_MESH_LR * 2.0 ** -8 * float(g.abs().max())
        errs[f] = float((getattr(local, f) - getattr(want, f)).detach()
                        .abs().max())
        if errs[f] > bound:
            fail(f"world 2 A2C (1, 2): {f} {errs[f]} from one process's "
                 f"step, beyond one bfloat16 ulp of its largest gradient "
                 f"times lr ({bound})")
    out["a2c_1x2"] = {"params_max_abs_err": errs,
                      "loss": float(loss_m), "loss_one_process": float(loss),
                      "hidden_local": int(local.b1.shape[0])}
    return out


def scaleout_rank(mode, world, rank, store, out_dir):
    """One rank of phase 53, run by :func:`scaleout_phase` as its own
    process (``--scaleout-rank``): joins the ``world``-rank group (NCCL for
    ``mode`` ``nccl``, gloo for ``gloo``) through the file ``store``, runs
    its part and writes ``<mode>_rank<rank>.json`` into ``out_dir``. The
    kernels come from the build directory the main process filled."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ai_safety_gridworlds_torch.parallel import multihost

    torch.set_num_threads(4)
    multihost.initialize(f"file://{store}", int(world), int(rank),
                         local_device_ids=[0], backend=mode, timeout_s=60)
    tally = LaunchTally()
    try:
        mesh = multihost.make_global_mesh(device="cuda")
        if mode == "nccl":
            out = scaleout_world1(torch, np, mesh, tally)
        else:
            out = scaleout_world2(torch, np, mesh, int(rank), out_dir, tally)
    finally:
        multihost.shutdown()
    out["sharded_launches"] = tally.counts
    out["mesh"] = mesh.shape
    with open(os.path.join(out_dir, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"rank {rank} ok", flush=True)


def run_ranks(mode, world, work):
    """Start ``world`` rank processes of ``mode`` and wait for each within
    SCALEOUT_TIMEOUT_S; on expiry or a failed rank, kill the group and fail.
    Returns each rank's JSON."""
    out_dir = os.path.join(work, mode)
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    # Every rank lives on this host: gloo and NCCL connect over the
    # loopback device, with no lookup of the host's name.
    env = dict(os.environ)
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        env.setdefault(var, "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scaleout-rank", mode,
         str(world), str(rank), store, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]
    logs = []
    deadline = time.perf_counter() + SCALEOUT_TIMEOUT_S
    for rank, p in enumerate(procs):
        try:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            fail(f"phase 53 {mode}: rank {rank} did not end within "
                 f"{SCALEOUT_TIMEOUT_S} s")
        logs.append(text)
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode or f"rank {rank} ok" not in text:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            fail(f"phase 53 {mode}: rank {rank} failed (exit {p.returncode})"
                 f":\n{text[-4000:]}")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{mode}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def trace_rows(torch, np, card):
    """A torch.profiler trace (``utils.profiling.trace``) of one fused
    ``train_step`` each on K3, K5, K7 and K9 at B = BATCH, H = HIDDEN: the
    device rows each holds, and whether its collection kernel is among them."""
    from torch.autograd import DeviceType

    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.utils import profiling

    out = {}
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ai_safety_gridworlds_torch", "_build",
                        f"traces-{os.getpid()}")
    for label, name, key in TRACE_PATHS:
        fused = BatchedEnv(name, batch_size=8, seed=SEED, device="cuda").fused
        state = ppo_fused.init_train_state(fused, BATCH, seed=SEED,
                                           config=cfg, device="cuda")
        step = ppo_fused.make_train_step(fused, cfg, device="cuda")
        state, _ = step(state)
        torch.cuda.synchronize()
        with profiling.trace(os.path.join(work, label)) as prof:
            state, _ = step(state)
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            rows[ev.key[:80]] = (ev.count, round(us / 1e3, 4))
        found = [k for k in rows if key in k]
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"trace of one {label} train_step ({name}): {len(rows)} device "
            f"rows; {key}: {found or 'absent'} "
            f"{[rows[k] for k in found]}; busiest {top}  [{card}]")
        out[label] = {"kernel_rows": {k: rows[k] for k in rows
                                      if "kernel" in k and "elementwise" not
                                      in k.lower()},
                      "collect_kernel_found": bool(found),
                      "device_rows": len(rows)}
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    return out


def scaleout_phase(torch, np, card):
    """Phase 53 (module docstring): returns its JSON with
    ``sharded_launches`` by kernel wrapper."""
    import shutil

    from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
    from ai_safety_gridworlds_torch.utils import profiling

    log("== 53. scale-out: one NCCL rank, two gloo ranks on the card, the "
        "sharded checkpoint, profiling")
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ai_safety_gridworlds_torch", "_build",
                        f"scaleout-{os.getpid()}")
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        (w1,) = run_ranks("nccl", 1, work)
        w1_s = time.perf_counter() - t0
        log(f"world 1 (NCCL, {w1['mesh']}): the sharded K1 rollout("
            f"{MAIN_STEPS}) at B={BATCH} equal to BatchedEnv's in every field; "
            f"two sharded island train_steps equal to make_train_step's in "
            f"params, Adam state and S; train_step {w1['train_step_ms']} ms, "
            f"sharded {w1['sharded_train_step_ms']} ms; collectives "
            f"({w1['all_reduces_a_step']} all-reduces, "
            f"{w1['grad_buffer_floats']} floats a gradient buffer) "
            f"{w1['collectives_ms']:.4f} ms, {w1['collectives_share']:.3%} of "
            f"the median sharded step  [{card}]")
        log("world 2: gloo ranks, both on the one card (NCCL refuses two "
            "ranks on one device); each all-reduce of a card tensor goes "
            "through the host")
        t0 = time.perf_counter()
        w2 = run_ranks("gloo", 2, work)
        w2_s = time.perf_counter() - t0
        for rank, r in enumerate(w2):
            log(f"world 2 rank {rank}: rollouts equal {r['rollouts']}")
            for label, row in r["train"].items():
                log(f"world 2 rank {rank} {label} ({row['kernel']}, B="
                    f"{row['batch']}): {row['exempt_lanes']} exempt lanes "
                    f"({row['exempt_differing']} differing), "
                    f"{row['diverged_lanes']} others diverged; params "
                    f"{row['params_max_abs_err']:.3g} from the CPU's two-rank "
                    f"step, metrics {row['metrics_max_abs_err']:.3g}; "
                    f"card step {row['card_step_ms']:.1f} ms (the rank's "
                    f"first step of this kind), CPU {row['cpu_step_ms']:.1f} "
                    f"ms" + (f"; a warm card step "
                             f"{row['warm_card_step_ms']:.1f} ms, its gloo "
                             f"collectives through the host "
                             f"{row['collectives_ms']:.3f} ms"
                             if "collectives_ms" in row else "")
                    + f"  [{card}]")
            log(f"world 2 rank {rank}: checkpoint {r['checkpoint']}; A2C (1, "
                f"2) {r['a2c_1x2']}  [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {}
    for r in [w1] + w2:
        for k, v in r["sharded_launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"sharded launches over phase 53's ranks: {launches}")
    for w in ("fused_firemaker_rollout", "fused_firemaker_collect",
              "fused_scalar_collect", "fused_island_ma_rollout",
              "fused_island_ma_collect", "fused_savanna_rollout",
              "fused_savanna_collect"):
        if not launches.get(w):
            fail(f"phase 53: {w} launched on no sharded path")

    rate = profiling.measure_steps_per_second(
        BoatRace(), batch_size=BATCH, n_steps=PROFILE_STEPS,
        n_reps=PROFILE_REPS, device="cuda")
    latency = profiling.per_step_latency(BoatRace(), n_steps=LATENCY_STEPS,
                                         device="cuda")
    log(f"measure_steps_per_second(boat_race, B={BATCH}, {PROFILE_STEPS} "
        f"steps x {PROFILE_REPS}): {rate['steps_per_sec']:.0f} env-steps/s by "
        f"the host clock (reps {[round(x) for x in rate['rep_steps_per_sec']]}"
        f"), by CUDA events "
        f"{[round(x) for x in rate['rep_device_steps_per_sec']]}; "
        f"per_step_latency {latency['seconds_per_step'] * 1e3:.3f} ms a step "
        f"(device {latency['device_seconds_per_step'] * 1e3:.3f} ms) on "
        f"{rate['device']}  [{card}]")
    traces = trace_rows(torch, np, card)
    seconds = time.perf_counter() - t_phase
    log(f"phase 53: {seconds:.1f} s (world 1 {w1_s:.1f} s, world 2 "
        f"{w2_s:.1f} s with the ranks' start)")
    return {"world1": w1, "world2": w2, "sharded_launches": launches,
            "measure_steps_per_second": rate, "per_step_latency": latency,
            "traces": traces, "seconds": seconds}


def trace_history():
    """Which torch.profiler sessions of one process record a hand-written
    kernel's row (``--trace-history``): one K3 ``train_step`` at B = BATCH,
    H = HIDDEN profiled as phase 8 profiles it (``device_busy_ms``) or by
    ``utils.profiling.trace``, fresh and after each piece of the whole
    run's history before phase 13 (a second session, 200 more K3 launches
    of the same engine, one and then 200 train steps of a second engine at
    B = 64 as phase 9's gate makes them, a CUDA-only session as phases 39
    and 45 make), and K5's step; one JSON line of (session, row found,
    kernel ms or device rows)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import _cuda

    _cuda.build(("fused_firemaker", "fused_scalar"))
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)

    def path(name):
        fused = BatchedEnv(name, batch_size=8, seed=SEED, device="cuda").fused
        state = ppo_fused.init_train_state(fused, BATCH, seed=SEED,
                                           config=cfg, device="cuda")
        step = ppo_fused.make_train_step(fused, cfg, device="cuda")
        step(state)
        torch.cuda.synchronize()
        return fused, state, step

    fm, fm_state, fm_step = path("firemaker_ex_ma")
    sessions = []

    def busy(label, step, state, key):
        _, kernel_ms, top = device_busy_ms(lambda: step(state), key, torch)
        sessions.append((label, kernel_ms > 0, kernel_ms))
        log(f"{label}: {key} {'recorded' if kernel_ms > 0 else 'absent'} "
            f"({kernel_ms:.4f} ms); busiest {top}")

    def traced(label):
        from torch.autograd import DeviceType

        from ai_safety_gridworlds_torch.utils import profiling

        work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "ai_safety_gridworlds_torch", "_build",
                            f"history-{os.getpid()}")
        with profiling.trace(work) as prof:
            fm_step(fm_state)
            torch.cuda.synchronize()
        rows = [ev.key for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == DeviceType.CUDA]
        found = any("fm_collect_kernel" in k for k in rows)
        sessions.append((label, found, len(rows)))
        log(f"{label}: fm_collect_kernel {'recorded' if found else 'absent'}"
            f" among {len(rows)} device rows")

    busy("1 fresh (device_busy_ms)", fm_step, fm_state, "fm_collect_kernel")
    busy("2 second session", fm_step, fm_state, "fm_collect_kernel")
    traced("3 profiling.trace")
    params = {k: v.detach() for k, v in fm_state.params.items()}
    for _ in range(200):
        fm.rollout_collect(fm_state.S, params, COLLECT_STEPS)
    torch.cuda.synchronize()
    busy("4 after 200 K3 launches of the same engine", fm_step, fm_state,
         "fm_collect_kernel")
    gate = BatchedEnv("firemaker_ex_ma", batch_size=8, seed=3,
                      device="cuda").fused
    gcfg = ppo_fused.FusedPPOConfig(n_steps=32, n_epochs=2, n_minibatches=2,
                                    hidden=32, lr=1e-3)
    gstate = ppo_fused.init_train_state(gate, 64, seed=3, config=gcfg,
                                        device="cuda")
    gstep = ppo_fused.make_train_step(gate, gcfg, device="cuda")
    gstate, _ = gstep(gstate)
    torch.cuda.synchronize()
    busy("5 after one train step of a second engine at B = 64", fm_step,
         fm_state, "fm_collect_kernel")
    for _ in range(200):
        gstate, _ = gstep(gstate)
    torch.cuda.synchronize()
    busy("6 after 200 more train steps at B = 64", fm_step, fm_state,
         "fm_collect_kernel")
    _, br_state, br_step = path("boat_race")
    busy("7 K5 step", br_step, br_state, "sc_collect_kernel")
    device_profile(lambda: fm_step(fm_state), torch)
    busy("8 after a CUDA-only session", fm_step, fm_state,
         "fm_collect_kernel")
    traced("9 profiling.trace")
    print(json.dumps({"sessions": sessions, "card": gpu_line(),
                      "torch": torch.__version__}), flush=True)


def scaleout_only():
    """Phase 53 alone (builds the kernels first): one JSON line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ai_safety_gridworlds_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build()
    log(f"built in {time.perf_counter() - t0:.1f} s")
    out = scaleout_phase(torch, np, gpu_line())
    print(json.dumps(out), flush=True)


def learners_only():
    """Phases 46-49 alone (no kernel build): one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    wrappers = kernel_wrappers()

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    t0 = time.perf_counter()
    card = gpu_line()
    out = learner_shell_phases(torch, np, torch.device("cuda", 0), card,
                               reset_counts, counts)
    out.update(scalar_shell_phase(np, card, reset_counts, counts))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def shells_only():
    """Phases 49-51 alone (the scalar, MO and multi-agent shells; no kernel
    build): one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    wrappers = kernel_wrappers()

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    t0 = time.perf_counter()
    card = gpu_line()
    out = scalar_shell_phase(np, card, reset_counts, counts)
    out["mo_shell"] = mo_shell_phase(np, card, reset_counts, counts)
    out["moma_shell"] = moma_shell_phase(np, card, reset_counts, counts)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def adapters_only():
    """Phase 52 alone (the adapters; no kernel build): one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    wrappers = kernel_wrappers()

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    t0 = time.perf_counter()
    out = adapter_phase(np, gpu_line(), reset_counts, counts)
    out["run_seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def generic_only():
    """Phases 36-45 alone (no kernel build): one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ai_safety_gridworlds_torch.ops import (
        _cuda,
        fused_firemaker,
        fused_island_ma,
        fused_savanna,
    )

    # Phase 39's and 45's fused comparisons.
    _cuda.build(("fused_firemaker", "fused_island_ma", "fused_savanna"))
    wrappers = (fused_firemaker.fused_firemaker_rollout,
                fused_island_ma.fused_island_ma_rollout,
                fused_savanna.fused_savanna_rollout)

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    out = generic_phases(torch, np, torch.device("cuda", 0), gpu_line(),
                         reset_counts, counts)
    print(json.dumps(out), flush=True)


def time_firemaker(root):
    """K1 per rollout(MAIN_STEPS) and K3 per collect(COLLECT_STEPS) at
    H = HIDDEN, B = BATCH, from ``init_packed(SEED, BATCH)``, each at the
    default tile of the port imported from the checkout at ``root``; one
    JSON line of milliseconds."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this timing needs a card")
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker

    dev = torch.device("cuda", 0)
    fused = FusedFiremaker(FiremakerExMa())
    S0 = fused.init_packed(SEED, BATCH, dev)
    params = seeded_params(fused, dev, np)
    out = {"root": os.path.abspath(root), "card": gpu_line(),
           "tile": fused.DEFAULT_TILE}
    out["k1_ms"] = cuda_ms(lambda: fused.rollout(S0, MAIN_STEPS), 5, torch)
    out["k3_ms"] = cuda_ms(
        lambda: fused.rollout_collect(S0, params, COLLECT_STEPS), 5, torch)
    print(json.dumps(out), flush=True)


def main():
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--time-scalar":
        return time_scalar(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--time-firemaker":
        return time_firemaker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--time-savanna":
        return time_savanna(sys.argv[2])
    if sys.argv[1:] == ["--sweep-savanna"]:
        return sweep_savanna()
    if len(sys.argv) == 3 and sys.argv[1] == "--time-island":
        return time_island(sys.argv[2])
    if sys.argv[1:] == ["--sweep-island"]:
        return sweep_island()
    if sys.argv[1:] == ["--sweep-savanna-agents"]:
        return sweep_savanna_agents()
    if sys.argv[1:] == ["--agents"]:
        return agents_only()
    if sys.argv[1:] == ["--generic"]:
        return generic_only()
    if sys.argv[1:] == ["--learners"]:
        return learners_only()
    if sys.argv[1:] == ["--shells"]:
        return shells_only()
    if sys.argv[1:] == ["--adapters"]:
        return adapters_only()
    if sys.argv[1:] == ["--scaleout"]:
        return scaleout_only()
    if sys.argv[1:] == ["--trace-history"]:
        return trace_history()
    if len(sys.argv) == 7 and sys.argv[1] == "--scaleout-rank":
        return scaleout_rank(*sys.argv[2:])
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import _cuda, interop, prng
    from ai_safety_gridworlds_torch.ops.fused_firemaker import (
        FusedFiremaker,
        fused_firemaker_collect,
        fused_firemaker_rollout,
    )
    from ai_safety_gridworlds_torch.ops.fused_island_ma import (
        fused_island_ma_collect,
        fused_island_ma_rollout,
    )
    from ai_safety_gridworlds_torch.ops.fused_savanna import (
        fused_savanna_collect,
        fused_savanna_rollout,
    )
    from ai_safety_gridworlds_torch.ops.fused_scalar import (
        fused_scalar_collect,
        fused_scalar_rollout,
    )

    wrappers = (fused_firemaker_rollout, fused_firemaker_collect,
                fused_scalar_rollout, fused_scalar_collect,
                fused_island_ma_rollout, fused_island_ma_collect,
                fused_savanna_rollout, fused_savanna_collect,
                prng.prf_words)

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

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

    # ---- 2. build, on a thread: phases 49-52 launch no kernel of the port
    # (each fails if one launched) and run on the host and the card
    # meanwhile; the kernel phases start once the build has ended.
    log("== 2. build, while phases 49-52 run")
    t0 = time.perf_counter()
    built = {}

    def build():
        try:
            built["logs"] = _cuda.build()
        except BaseException as e:  # re-raised on the main thread
            built["error"] = e
        built["seconds"] = time.perf_counter() - t0

    builder = threading.Thread(target=build, name="nvcc")
    builder.start()
    shell = scalar_shell_phase(np, card, reset_counts, counts)
    mo_shell = mo_shell_phase(np, card, reset_counts, counts)
    moma_shell = moma_shell_phase(np, card, reset_counts, counts)
    adapters = adapter_phase(np, card, reset_counts, counts)
    # The shells' class-wide counters and randomized maps start afresh for
    # the phases after them.
    fresh_shell_statics()
    builder.join()
    if "error" in built:
        raise built["error"]
    logs = built["logs"]
    log(f"built {sorted(logs)} into {_cuda.build_dir()} in "
        f"{built['seconds']:.1f} s (phases 49-52 ran meanwhile; "
        f"{time.perf_counter() - t0:.1f} s in all)")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "entry function")):
                log(f"  [{name}] {line.strip()}")
    for kernel, use in ptxas_use(logs.get("fused_island_ma", "")).items():
        log(f"ptxas {kernel}: {use['registers']} registers, "
            f"{use['spill_stores']} / {use['spill_loads']} bytes spilled "
            "(stores / loads)")
    savanna_spills(logs.get("fused_savanna", ""))

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
    for label, kw, steps, start, batch in K1_CHECKS:
        fused = FusedFiremaker(FiremakerExMa(**kw))
        if start == "init":
            S0 = fused.init_packed(SEED, batch, dev)
        else:
            S0 = interop.busy_firemaker_state(fused, SEED, batch, dev)
        t0 = time.perf_counter()
        Sk = fused.rollout(S0, steps)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        Sp = fused.rollout_plain(S0, steps)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        k1_err = max(k1_err, rollout_equal(f"K1 {label}", fused, Sk, Sp, torch))
        eps = Sk["stats_episodes"]
        fires = int((Sk["fire"] > 0.5).sum())
        log(f"K1 {label} (B={batch}, {fused.n} agents): {steps} steps equal "
            f"in all {len(fused.STATE_FIELDS)} fields; episodes per lane "
            f"{int(eps.min())}..{int(eps.max())}, burning cells {fires}; "
            f"kernel {tk:.3f} s, plain {tp:.3f} s")
        # Every run from init of 300 steps or more passes its first
        # truncation.
        if start == "init" and steps >= 300 and int(eps.min()) < 1:
            fail(f"K1 {label} check did not cross an auto-reset")
        if start == "busy" and int(Sk["draw_ctr"].to(torch.int64).min()) >= steps:
            fail("K1 busy check did not cross the draw-counter wrap")

    # ---- 5. the main path
    log("== 5. main path: BatchedEnv('firemaker_ex_ma', 4096, device='cuda')")
    env = BatchedEnv("firemaker_ex_ma", batch_size=BATCH, seed=SEED,
                     device="cuda")
    if env.kernel != "fused_cuda":
        fail(f"BatchedEnv reports kernel {env.kernel!r}")
    fused = env.fused
    S_start = {k: v.clone() for k, v in env.state.items()}
    torch.cuda.synchronize()
    reset_counts()
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
    launches = counts()
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
    S_end = fused.rollout(S_start, MAIN_STEPS)
    # Acting sub-steps of the timed call: t counts them (no lane resets
    # within rollout(256) from init_packed).
    if int(S_end["stats_episodes"].sum()) != int(S_start["stats_episodes"].sum()):
        fail("the timed K1 call crossed an episode end")
    k1_acting = int((S_end["t"].to(torch.int64) - S_start["t"]).sum())
    k1_bound_ms, k1_bound_by = bound(
        2 * 4 * state_words(fused) * BATCH, step_ops(fused, k1_acting)
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_plain(S_start, PLAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    k1_plain_ms = ((time.perf_counter() - t0) * 1e3 * MAIN_STEPS
                   / PLAIN_TIMED_STEPS)
    log(f"K1 rollout({MAIN_STEPS}) at B={BATCH}: {k1_ms:.3f} ms "
        f"({BATCH * MAIN_STEPS / k1_ms * 1e3:.0f} env-steps/s); plain "
        f"{k1_plain_ms:.3f} ms ({BATCH * MAIN_STEPS / k1_plain_ms * 1e3:.0f} "
        f"env-steps/s; {PLAIN_TIMED_STEPS} steps scaled); one thread per "
        f"lane {K1_BEFORE_MS} ms "
        f"({k1_ms / K1_BEFORE_MS - 1:+.2%}); bound {k1_bound_ms:.4f} ms "
        f"({k1_bound_by}), {k1_bound_ms / k1_ms:.2%} of it  [{card}]")
    # K1 alone by lane count and threads per block, from init_packed (3
    # timed calls each).
    for b in SWEEP_BATCHES:
        S_b = fused.init_packed(SEED, b, dev)
        for tile in TILES:
            ms = cuda_ms(lambda: fused.rollout(S_b, MAIN_STEPS, tile=tile), 3,
                         torch)
            log(f"K1 sweep: rollout({MAIN_STEPS}) B={b} tile={tile} "
                f"({tile // 32} lanes per block): {ms:.3f} ms, "
                f"{b * MAIN_STEPS / ms * 1e3:.0f} env-steps/s  [{card}]")
        del S_b


    # ---- 6. K1's linear-policy branch
    log("== 6. K1 linear-policy branch vs plain rollout")
    fused = FusedFiremaker(FiremakerExMa())
    A = fused.amax - fused.amin + 1
    F = fused.POLICY_FEATURES
    rng = np.random.default_rng(SEED)
    S0 = fused.init_packed(SEED, BATCH, dev)
    pol_launches = fused_firemaker_rollout.launches
    finals = []
    for rnd in range(2):
        fused.set_policies(
            rng.normal(size=(BATCH, A, F)).astype(np.float32),
            rng.normal(size=(BATCH, A)).astype(np.float32), 0.1,
        )
        Sk = fused.rollout(S0, POLICY_STEPS)
        Sp = fused.rollout_plain(S0, POLICY_STEPS)
        rollout_equal(f"K1 linear policy (round {rnd})", fused, Sk, Sp, torch)
        finals.append(Sk)
        log(f"K1 linear policy, round {rnd}: {POLICY_STEPS} steps equal in all "
            f"{len(fused.STATE_FIELDS)} fields; reward sums "
            f"{Sk['stats_rewards'].sum(dim=1).tolist()}")
    if not bool(lanes_differ(finals[0], finals[1], ("pos",)).any()):
        fail("the second policy changed nothing: the kernel read a stale policy")
    pol_launches = fused_firemaker_rollout.launches - pol_launches
    k1_linear_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    fused.set_policies(None, None)
    k1_uniform_ms = cuda_ms(lambda: fused.rollout(S0, POLICY_STEPS), 3, torch)
    log(f"K1 rollout({POLICY_STEPS}) at B={BATCH}: linear policy "
        f"{k1_linear_ms:.3f} ms, uniform {k1_uniform_ms:.3f} ms  [{card}]")

    # ---- 7. K3 against the plain collection
    log("== 7. K3 fused_firemaker_collect vs plain collection")
    fused = FusedFiremaker(FiremakerExMa())
    k3_err, exempt, flipped, diverged = check_collect(
        "K3", fused, seeded_params(fused, dev, np),
        lambda seed: interop.busy_firemaker_state(fused, seed, BATCH, dev),
        dev, torch,
    )

    # ---- 8. the training path
    log("== 8. training path: make_train_step(..., device='cuda'), "
        f"B={BATCH}, H={HIDDEN}")
    cfg = ppo_fused.FusedPPOConfig(n_steps=COLLECT_STEPS, n_epochs=2,
                                   n_minibatches=4, hidden=HIDDEN)
    fused = FusedFiremaker(FiremakerExMa())
    state = ppo_fused.init_train_state(fused, BATCH, seed=SEED, config=cfg,
                                       device="cuda")
    train_step = ppo_fused.make_train_step(fused, cfg, device="cuda")
    state, metrics = train_step(state)  # warm-up
    torch.cuda.synchronize()
    step_s = []
    reset_counts()
    for call in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if fused_firemaker_collect.launches != call + 1:
            fail("K3 did not launch once per train_step")
    train_launches = counts()
    log(f"launch counts over the training path: {train_launches}")
    if (train_launches["fused_firemaker_collect"] != TRAIN_CALLS
            or train_launches["fused_firemaker_rollout"] != 0):
        fail("the training path did not run on K3 alone")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite training metric {k}")
    env_steps = COLLECT_STEPS * BATCH
    for call, s_ in enumerate(step_s):
        log(f"train_step {call}: {s_ * 1e3:.3f} ms host clock, "
            f"{env_steps / s_:.0f} training env-steps/s  [{card}]")
    params = {k: v.detach() for k, v in state.params.items()}
    S_c = state.S
    k3_ms = cuda_ms(lambda: fused.rollout_collect(S_c, params, COLLECT_STEPS),
                    3, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.rollout_collect_plain(S_c, params, COLLECT_STEPS)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    log(f"K3 collect({COLLECT_STEPS}) at B={BATCH}, H={HIDDEN}: {k3_ms:.3f} ms; "
        f"plain collection {k3_plain_ms:.3f} ms; median train_step "
        f"{step_ms:.3f} ms, {1 - k3_ms / step_ms:.2%} of it outside K3 "
        f"(GAE, {cfg.n_epochs * cfg.n_minibatches} minibatch updates, Adam); "
        f"one thread per lane {K3_BEFORE_MS} ms "
        f"({k3_ms / K3_BEFORE_MS - 1:+.2%})  [{card}]")
    log("metrics of the last step: " + json.dumps(
        {k: float(v) for k, v in metrics.items()}))
    # Where the rest of a step goes: GAE (with the minibatch slicing), then
    # the epochs of minibatch updates with Adam, on the last trajectory.
    _, traj, boot = fused.rollout_collect(S_c, params, COLLECT_STEPS)
    gae_ms = cuda_ms(lambda: ppo_fused._minibatches(traj, boot, cfg), 3, torch)
    upd_ms = cuda_ms(lambda: ppo_fused._update_from_traj(
        traj, boot, state.params, state.opt, ppo_fused._dims(fused), cfg), 3,
        torch)
    log(f"outside K3: GAE {gae_ms:.3f} ms, GAE + "
        f"{cfg.n_epochs * cfg.n_minibatches} minibatch updates {upd_ms:.3f} ms"
        f"  [{card}]")
    # The device's busy time within one train_step, from torch.profiler's
    # kernel records, against the median unprofiled step.
    busy_ms, k3_prof_ms, _ = device_busy_ms(lambda: train_step(state),
                                            "fm_collect_kernel", torch)
    if busy_ms > 0:
        log(f"profiler, one train_step: device busy {busy_ms:.3f} ms "
            f"(K3 {k3_prof_ms:.3f} ms), idle share "
            f"{1 - busy_ms / step_ms:.2%} of the median step  [{card}]")
    else:
        log("profiler, one train_step: no device time recorded; device idle "
            "share not measured")
    k3_bytes = (2 * 4 * state_words(fused) * BATCH
                + 4 * sum(r for _, r, _ in fused._traj_layout()) * env_steps
                + 4 * fused.n * BATCH
                + 4 * sum(v.numel() for v in params.values()))
    # The timed calls run from the training state: count every lane-step
    # (reset steps, where no agent acts, are under 1% at max_iterations
    # 1000) for the step and the MLP of every agent.
    k3_ops = (step_ops(fused, fused.n * env_steps)
              + fused.n * env_steps * mlp_ops(fused, HIDDEN))
    k3_bound_ms, k3_bound_by = bound(k3_bytes, k3_ops)
    log(f"K3 bound {k3_bound_ms:.4f} ms ({k3_bound_by}), "
        f"{k3_bound_ms / k3_ms:.2%} of K3's time  [{card}]")

    # ---- 9. the learning gate
    log("== 9. learning gate: firemaker, max_iterations=50, B=64, 200 updates")
    fused = FusedFiremaker(FiremakerExMa(max_iterations=50))
    gcfg = ppo_fused.FusedPPOConfig(n_steps=32, n_epochs=2, n_minibatches=2,
                                    hidden=32, lr=1e-3)
    gstate = ppo_fused.init_train_state(fused, 64, seed=3, config=gcfg,
                                        device="cuda")
    gtrain = ppo_fused.make_train_step(fused, gcfg, device="cuda")
    before = fused_firemaker_collect.launches
    t0 = time.perf_counter()
    ev0 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    for _ in range(200):
        gstate, gm = gtrain(gstate)
    ev1 = ppo_fused.evaluate(fused, gstate.params, n_steps=128, batch=64,
                             seed=9, device="cuda")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    log(f"r0 {r0}  r1 {r1}  episodes {ev0['episodes']} -> {ev1['episodes']}  "
        f"({fused_firemaker_collect.launches - before} K3 launches, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not (ev0["episodes"] > 100 and ev1["episodes"] > 100):
        fail("the learning gate saw too few episodes")
    if not (r1 - r0 > 40.0 and r1 > 0.0):
        fail(f"the learning gate failed: r0 {r0}, r1 {r1}")

    scalar_kernels = scalar_phases(torch, np, dev, card, reset_counts, counts)
    island_kernels, island_prf = island_phases(torch, np, dev, card,
                                               reset_counts, counts)
    savanna_kernels, savanna_prf = savanna_phases(torch, np, dev, card,
                                                  reset_counts, counts)
    k4, k5 = scalar_kernels
    k4["launches_by_path"] = {"scalar": k4["launches"]}
    k5["launches_by_path"] = {"scalar": k5["launches"]}
    train_paths = []
    for phases in (scalar_ex_phases, scalar_last_phases):
        (k4_err, k4_rows, k5_err, collect, path_launches,
         k5_row) = phases(torch, np, dev, card, reset_counts, counts)
        k4["launches_by_path"].update(
            {row["env"]: row["launches"] for row in k4_rows})
        k4["max_abs_err"] = max(k4["max_abs_err"], k4_err)
        k4["per_env"] += k4_rows
        k5["launches_by_path"][k5_row["env"]] = k5_row["launches"]
        k5["max_abs_err"] = max(k5["max_abs_err"], k5_err)
        k5["exempt_lane_steps"] += collect["exempt"]
        k5["flipped_lane_steps"] += collect["flipped"]
        k5["diverged_lanes"].update(collect["diverged"])
        k5["per_env"].append(k5_row)
        train_paths.append(path_launches)
    k4["launches"] = sum(k4["launches_by_path"].values())
    k5["launches"] = sum(k5["launches_by_path"].values())
    # Every scalar path against its time before the step table.
    for row in k4["per_env"]:
        if row["env"] in K4_BEFORE_MS:
            before = K4_BEFORE_MS[row["env"]]
            log(f"K4 {row['env']} rollout({row['steps']}): {row['ms']:.3f} ms, "
                f"before {before} ms ({row['ms'] / before - 1:+.2%})  [{card}]")
    for row in k5["per_env"]:
        if row["env"] in K5_BEFORE_MS:
            before = K5_BEFORE_MS[row["env"]]
            log(f"K5 {row['env']} collect({COLLECT_STEPS}): {row['ms']:.3f} ms, "
                f"before {before} ms ({row['ms'] / before - 1:+.2%})  [{card}]")

    # ---- 33. K4's lanes per warp
    log(f"== 33. K4 by lanes a warp {LANES_PER_WARP} on the 18 scalar main "
        "paths")
    k4["lanes_per_warp_ms"] = scalar_lane_sweep(card, torch)

    # ---- 34. K8's lane groups
    log(f"== 34. K8 by threads a lane on the savanna main paths at B = "
        f"{GROUP_SWEEP_BATCHES}")
    savanna_kernels[0]["threads_per_lane_ms"] = savanna_group_sweep(
        card, torch, SAVANNA_TIMED[:2])

    # ---- 35. K6's and K7's lane groups
    log(f"== 35. K6 and K7 by threads a lane on the island main and training "
        f"paths at B = {ISLAND_GROUP_BATCHES} / {ISLAND_COLLECT_BATCHES}")
    island_kernels[0]["threads_per_lane_ms"] = island_group_sweep(card, torch)
    island_kernels[1]["threads_per_lane_ms"] = island_group_sweep(
        card, torch, collect=True)

    k8_agents, k9_agents, agent_launches, agent_prf = savanna_agent_phase(
        torch, np, dev, card, reset_counts, counts)
    k8, k9 = savanna_kernels
    k8["launches_by_path"] = {r["config"]: r["launches"]
                              for r in k8["per_config"]}
    k9["launches_by_path"] = {"train": k9["launches"]}
    for k, rows in ((k8, k8_agents), (k9, k9_agents)):
        k["launches_by_path"].update(
            {p: v for p, v in agent_launches.items()
             if p.startswith("train") == (k is k9)})
        k["launches"] = sum(k["launches_by_path"].values())
        k["max_abs_err"] = max([k["max_abs_err"]]
                               + [r["max_abs_err"] for r in rows])
        k["per_agent_count"] = rows

    generic = generic_phases(torch, np, dev, card, reset_counts, counts)
    learners = learner_shell_phases(torch, np, dev, card, reset_counts,
                                    counts)
    learners.update(shell)
    scaleout = scaleout_phase(torch, np, card)

    # ---- 55. results
    k2_bound_ms, k2_bound_by = bound(24 * n_words, 24 * n_words)
    kernels = [{
        "name": "fused_firemaker_rollout", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_firemaker.cu",
        "replaces": K1_REPLACES,
        "launches": launches["fused_firemaker_rollout"],
        "policy_search_launches": pol_launches,
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
    }, {
        "name": "fused_firemaker_collect", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/fused_firemaker.cu",
        "replaces": K3_REPLACES,
        "launches": train_launches["fused_firemaker_collect"],
        "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms, "bound_by": k3_bound_by, "library_ms": None,
        "exempt_lane_steps": exempt, "flipped_lane_steps": flipped,
        "diverged_lanes": diverged,
    }] + scalar_kernels + island_kernels + savanna_kernels
    for k in kernels:
        k["sharded_launches"] = scaleout["sharded_launches"].get(k["name"], 0)
    checked_off_path = [{
        "name": "prf_words", "route": "cuda",
        "source": "ai_safety_gridworlds_torch/ops/csrc/prf_words.cu",
        "replaces": K2_REPLACES,
        "launches": (launches["prf_words"] + train_launches["prf_words"]
                     + island_prf + savanna_prf + agent_prf
                     + sum(t["prf_words"] for t in train_paths)),
        "check_launches": k2_check_launches,
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
    }]
    log(f"run time {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": kernels, "checked_off_path": checked_off_path,
                    "generic": generic, "learners": learners,
                    "mo_shell": mo_shell, "moma_shell": moma_shell,
                    "adapters": adapters, "scaleout": scaleout}))
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
