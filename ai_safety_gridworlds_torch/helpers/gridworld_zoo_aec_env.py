"""PettingZoo AEC (turn-based) adapter.

Port of ``ai_safety_gridworlds_tpu/helpers/gridworld_zoo_aec_env.py``, with
per-turn stepping: every ``step(action)`` advances the multi-agent shell
with ``{agent: action}`` at once, so the next agent's observation already
shows this agent's move within the same cycle. Also:

* the dead-step protocol: a terminated agent must call ``step(None)`` once
  more, and only that call removes it from ``agents`` and the bookkeeping
  dicts;
* ``pre_step_callback``, which rewrites each action;
* the acting agent's hidden-reward change in the step info;
* ``agent_selection`` cycling over ``possible_agents``, skipping removed
  agents;
* per-agent cumulative rewards, cleared at the agent's own step and
  accrued from every agent's step.

The spaces, agent names, perspectives and info extras come from the
Parallel adapter, and with them the shell on ``device`` (``"cuda"``
unless the caller asks for ``"cpu"``). Where PettingZoo is not installed,
the base class is the stand-in of :mod:`._spaces`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ai_safety_gridworlds_torch.core.timestep import StepType
from ai_safety_gridworlds_torch.helpers._spaces import AECEnv
from ai_safety_gridworlds_torch.helpers.gridworld_zoo_parallel_env import (
    INFO_DISCOUNT,
    INFO_HIDDEN_REWARD,
    INFO_OBSERVED_REWARD,
    GridworldZooParallelEnv,
)


class GridworldZooAecEnv(AECEnv):
    """AEC adapter over a stateful shell of the port.

    The spaces, agent names, perspectives and info extras are the Parallel
    adapter's; each agent's turn steps the shell at once.
    """

    metadata = {"render_modes": ["human", "ansi", "rgb_array"]}

    def __init__(
        self,
        env_name: str,
        pre_step_callback=None,
        **kwargs,
    ):
        self._parallel = GridworldZooParallelEnv(env_name, **kwargs)
        self._env = self._parallel._env
        self._is_moma = self._parallel._is_moma
        self._pre_step_callback = pre_step_callback
        self.possible_agents = list(self._parallel.possible_agents)
        self.agent_name_mapping = dict(self._parallel.agent_name_mapping)
        self.agent_name_reverse_mapping = dict(
            self._parallel.agent_name_reverse_mapping
        )
        self._use_transitions = self._parallel._use_transitions
        self._flatten_observations = self._parallel._flatten_observations
        self._test_death = self._parallel._test_death
        self._test_death_probability = self._parallel._test_death_probability
        self._np_random = self._parallel._np_random
        self._init_cycle_state(agent_boards={})

    # ------------------------------------------------------------- lifecycle

    def _init_cycle_state(self, agent_boards):
        self._agents = list(self.possible_agents)
        self._next_agent = self.possible_agents[0]
        self._next_agent_index = 0
        self._all_agents_done = False
        self._rewards = {a: 0.0 for a in self.possible_agents}
        self._cumulative_rewards = {a: 0.0 for a in self.possible_agents}
        self.terminations = {a: False for a in self.possible_agents}
        self.truncations = {a: False for a in self.possible_agents}
        self._infos = {a: {} for a in self.possible_agents}
        self._test_deads = {a: False for a in self.possible_agents}
        self._last_hidden_reward = {a: 0.0 for a in self.possible_agents}
        # Raw per-agent boards after the latest (any agent's) step; what each
        # agent last SAW (for transitions stacking).
        self._agent_boards = dict(agent_boards)
        self._last_observed_agent_board = {}
        self._given_agents_last_step_result = {
            a: (None, 0.0, False, False, {}) for a in self.possible_agents
        }

    def reset(self, seed=None, options=None):
        if seed is not None:
            np.random.seed(seed)
            self._np_random = np.random.default_rng(seed)
            self._parallel._np_random = self._np_random
        if self._is_moma and options:
            ts = self._env.reset(options=options)
        else:
            ts = self._env.reset()
        boards = self._parallel._agent_observations(ts.observation)
        self._init_cycle_state(agent_boards=boards)
        self._last_observation = ts.observation

    # ------------------------------------------------------------ properties

    @property
    def agents(self):
        return self._agents

    @property
    def num_agents(self):
        return len(self._agents)

    @property
    def max_num_agents(self):
        return len(self.possible_agents)

    @property
    def agent_selection(self):
        return self._next_agent

    @property
    def rewards(self):
        return self._rewards

    @property
    def infos(self):
        return self._infos

    def action_space(self, agent):
        return self._parallel.action_space(agent)

    def observation_space(self, agent):
        return self._parallel.observation_space(agent)

    @property
    def action_spaces(self):
        return self._parallel.action_spaces

    @property
    def observation_spaces(self):
        return self._parallel.observation_spaces

    # -------------------------------------------------------------- observe

    def observe(self, agent):
        """The agent's perspective after the latest step by any agent."""
        board = self._agent_boards.get(agent)
        if board is None:
            return None
        board = np.asarray(board, np.float32)
        if self._use_transitions:
            last = self._last_observed_agent_board.get(agent)
            if last is None:
                last = np.zeros_like(board)
            state = np.stack([last, board], axis=0)
            self._last_observed_agent_board[agent] = board
        else:
            state = board[np.newaxis, :]
        if self._flatten_observations:
            state = state.flatten()
        return state

    def observe_info(self, agent):
        """The info dict of ``agent`` from the latest step, whoever's turn
        it is."""
        return self._infos.get(agent, {})

    def last_for_agent(self, agent=None, observe=True):
        """(observation, cumulative reward, terminated, truncated, info) for
        ``agent``."""
        if agent is None:
            agent = self._next_agent
        if observe:
            state = GridworldZooAecEnv.observe(self, agent)
            reward = self._cumulative_rewards.get(agent, 0.0)
            terminated = self.terminations.get(agent, False)
            truncated = self.truncations.get(agent, False)
            info = self._infos.get(agent, {})
            return (state, reward, terminated, truncated, info)
        (state, reward, terminated, truncated, info) = (
            self._given_agents_last_step_result[agent]
        )
        if self._use_transitions and state is not None:
            self._last_observed_agent_board[agent] = state[-1]
        if self._flatten_observations and state is not None:
            state = np.asarray(state).flatten()
        return (state, reward, terminated, truncated, info)

    def last(self, observe=True):
        result = GridworldZooAecEnv.last_for_agent(
            self, self._next_agent, observe
        )
        (state, reward, terminated, truncated, info) = result
        if not observe:  # PettingZoo's convention
            state = None
        return (state, reward, terminated, truncated, info)

    # ----------------------------------------------------------------- step

    def step(self, action):
        agent = self._next_agent
        if self._pre_step_callback is not None:
            action = self._pre_step_callback(agent, action)

        if self.terminations.get(agent) or self.truncations.get(agent):
            # The dead-step protocol: the only valid action is None, and
            # this call removes the agent.
            action_step = (
                action["step"] if isinstance(action, dict) else action
            )
            if action_step is not None:
                raise ValueError(
                    "When an agent is dead, the only valid action is None"
                )
            del self.terminations[agent]
            del self.truncations[agent]
            del self._cumulative_rewards[agent]
            del self._infos[agent]
            del self._last_hidden_reward[agent]
            self._agents.remove(agent)
            # Rewards from the previous step are cleared; no agent collects
            # reward from a dead step.
            self._rewards = {a: 0.0 for a in self._agents}
            self._move_to_next_agent()
            return

        # --- step the shell immediately for this agent's turn --------------
        char = self.agent_name_mapping[agent]
        if self._is_moma:
            ts = self._env.step({char: action})
        else:
            ts = self._env.step(
                int(np.asarray(action).item())
                if not isinstance(action, dict)
                else action
            )
        self._last_observation = ts.observation
        self._agent_boards.update(
            self._parallel._agent_observations(ts.observation)
        )

        # Rewards accrue to every live agent from this sub-step.
        if self._is_moma:
            if ts.reward is None:
                rewards = {a: 0.0 for a in self._agents}
            else:
                # Keys must track env.agents: the shell reports every
                # agent char, including agents already removed by the
                # dead-step protocol.
                rewards = {
                    self.agent_name_reverse_mapping[c]: (
                        0.0 if r is None else r
                    )
                    for c, r in ts.reward.items()
                    if self.agent_name_reverse_mapping[c] in self._agents
                }
        else:
            rewards = {
                a: 0.0 if ts.reward is None else ts.reward
                for a in self._agents
            }

        # The acting agent's hidden-reward change.
        cumulative_hidden = self._env._get_hidden_reward(default_reward=None)
        if cumulative_hidden is not None:
            if isinstance(cumulative_hidden, dict):
                value = cumulative_hidden[char]
            else:
                value = float(np.sum(cumulative_hidden))
            hidden_reward = value - self._last_hidden_reward[agent]
            self._last_hidden_reward[agent] = value
        else:
            hidden_reward = None

        info = {
            INFO_OBSERVED_REWARD: rewards.get(agent, 0.0),
            INFO_HIDDEN_REWARD: hidden_reward,
            INFO_DISCOUNT: ts.discount,
        }
        info.update(self._parallel._extra_info(ts.observation))
        self._infos[agent] = info

        if self._test_death:
            for a in self.possible_agents:
                if self._test_deads.get(a):
                    rewards.pop(a, None)

        # Agents terminated/truncated on a PREVIOUS turn accrue nothing
        # (PettingZoo api_test: ``last()`` must equal the accumulation of
        # ``env.rewards`` since the agent's last action — the reference
        # adapter accrues the shell's repeated dead-agent rewards into
        # ``_cumulative_rewards`` while zeroing ``rewards``, which violates
        # that invariant; see PARITY.md). Iterate live agents, not the
        # rewards keys: test_death pops its dead agents from ``rewards``
        # above, and they must read 0.0 (not a stale value) in
        # ``env.rewards`` until their dead step removes them.
        for a in self._agents:
            if self.terminations.get(a) or self.truncations.get(a):
                rewards[a] = 0.0

        # Cumulative rewards: cleared for the acting agent, then accrued for
        # everyone from this step.
        self._cumulative_rewards[agent] = 0.0
        for a, r in rewards.items():
            if a in self._cumulative_rewards:
                self._cumulative_rewards[a] = (
                    self._cumulative_rewards[a] + r
                )

        # Done is read for the acting agent only.
        if self._is_moma:
            st = ts.step_type[char]
        else:
            st = ts.step_type
        done = int(st) == int(StepType.LAST)
        if (
            self._test_death
            and not done
            and self._np_random.random() < self._test_death_probability
        ):
            done = True
            self._test_deads[agent] = True

        self._rewards.update(rewards)

        self.terminations[agent] = done
        self.truncations[agent] = False
        self._given_agents_last_step_result[agent] = (
            GridworldZooAecEnv.observe(self, agent),
            self._cumulative_rewards[agent],
            done,
            False,
            info,
        )
        self._move_to_next_agent()

    def _move_to_next_agent(self):
        """Cycle ``agent_selection`` over ``possible_agents``, skipping
        removed agents."""
        for search in range(len(self.possible_agents)):
            self._next_agent_index = (self._next_agent_index + 1) % len(
                self.possible_agents
            )
            candidate = self.possible_agents[self._next_agent_index]
            if candidate in self._agents:
                self._next_agent = candidate
                return
        self._next_agent_index = -1
        self._next_agent = None
        self._all_agents_done = True

    def agent_iter(self, max_iter: int = 2 ** 63):
        """Iterator over the acting agent until all are done."""
        env = self

        class _Iter:
            def __init__(self):
                self.n = 0

            def __iter__(self):
                return self

            def __next__(self):
                if self.n < max_iter and not env._all_agents_done:
                    self.n += 1
                    return env._next_agent
                raise StopIteration

        return _Iter()

    # ------------------------------------------------------------- plumbing

    def render(self, mode=None):
        return self._parallel.render(mode)

    def close(self):
        self._parallel.close()

    def get_env_layout_seed(self):
        return self._env.get_env_layout_seed()

    def get_trial_no(self):
        return self._env.get_trial_no()

    def get_episode_no(self):
        return self._env.get_episode_no()

    # What each agent would see from another location (read only).
    def observe_infos_from_location(self, agent_coordinates: dict):
        env = self._env
        ts_obs = env.last_observation()
        persp = env.agent_perspectives_with_layers(
            ts_obs,
            include_layers=False,
            observe_from_agent_coordinates={
                self.agent_name_mapping[a]: coord
                for a, coord in agent_coordinates.items()
            },
        )
        return {
            self.agent_name_reverse_mapping[c]: v
            for c, v in persp.items()
        }
