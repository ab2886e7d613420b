"""Story: programmable sequences of gridworld games behind one interface.

Port of ``ai_safety_gridworlds_tpu/core/storytelling.py`` (pycolab's
``storytelling.py:35-654``): chain games as "chapters" of one continuous
episode. A chapter's end is invisible to the player: the finished
chapter's terminal observation and discount are dropped, its last reward
goes onto the FIRST step of the next chapter (as a MID step), and only the
last chapter's end ends the episode.

The chapters share a ``plot`` dict (the only state the reference copies
between engines). A chapter may steer the story by setting
``plot["next_chapter"]``; ``None`` ends it.

Chapters are functions that return a stateful shell (the port's
``helpers/safety_env.SafetyEnvironment`` or one like it: ``reset() ->
TimeStep``, ``step(action) -> TimeStep``, on the device the function
chose); a function that takes an argument gets the plot.
"""

from __future__ import annotations

import inspect
from typing import Union

from ai_safety_gridworlds_torch.core.cropping import ScrollingCropper
from ai_safety_gridworlds_torch.core.timestep import StepType
from ai_safety_gridworlds_torch.helpers.safety_env import TimeStep


class Story:
    """Sequence (or graph) of chapter environments
    (``storytelling.py:35-172``)."""

    def __init__(
        self,
        chapters: Union[list, tuple, dict],
        first_chapter=None,
        croppers=None,
    ):
        if isinstance(chapters, dict):
            if first_chapter is None:
                raise ValueError(
                    "dict-based stories need an explicit first_chapter"
                )
            self._chapters = dict(chapters)
            self._order = None
            self._first = first_chapter
        else:
            self._chapters = {i: c for i, c in enumerate(chapters)}
            self._order = list(range(len(chapters)))
            self._first = 0
        self._croppers = croppers
        self._crop_corner = None  # ScrollingCropper state, per chapter
        self.the_plot: dict = {}
        self._current_key = None
        self._env = None
        self._game_over = True

    # ------------------------------------------------------------- helpers

    def _build(self, key):
        make = self._chapters[key]
        if inspect.signature(make).parameters:
            env = make(self.the_plot)
        else:
            env = make()
        self._current_key = key
        self._crop_corner = None  # new chapter => fresh scroll window
        return env

    def _next_key(self):
        """Next chapter key: an explicit ``plot['next_chapter']`` wins; list
        stories otherwise advance in order (``storytelling.py:71-80``)."""
        if "next_chapter" in self.the_plot:
            nxt = self.the_plot.pop("next_chapter")
            if nxt is None or nxt not in self._chapters:
                return None
            return nxt
        if self._order is not None:
            idx = self._order.index(self._current_key)
            if idx + 1 < len(self._order):
                return self._order[idx + 1]
        return None

    def _chapter_croppers(self):
        """Croppers for the CURRENT chapter: a per-chapter dict (the
        reference's ``croppers=``, ``storytelling.py:114``) or a flat list
        for every chapter. Entries are fixed croppers or ``(ScrollingCropper,
        position_fn)`` pairs: ``position_fn(env) -> (row, col)`` reads the
        tracked position (on the host); the Story threads the window corner
        and starts it afresh on a chapter switch (``cropping.py:380-394``)."""
        if not self._croppers:
            return []
        if isinstance(self._croppers, dict):
            entry = self._croppers.get(self._current_key)
            if entry is None:
                return []
            return entry if isinstance(entry, (list, tuple)) and not (
                len(entry) == 2 and callable(entry[1])
            ) else [entry]
        return list(self._croppers)

    def _crop(self, timestep):
        croppers = self._chapter_croppers()
        if not croppers:
            return timestep
        obs = dict(timestep.observation)
        for cropper in croppers:
            position_fn = None
            if isinstance(cropper, tuple):
                cropper, position_fn = cropper
            if isinstance(cropper, ScrollingCropper):
                if position_fn is None:
                    raise TypeError(
                        "Story ScrollingCropper entries need a "
                        "(cropper, position_fn) pair"
                    )
                pos = position_fn(self._env)
                corner = self._crop_corner
                new_corner = corner
                for key in ("board", "ascii_codes"):
                    if key in obs:
                        obs[key], new_corner = cropper.crop(
                            obs[key], position=pos, corner=corner
                        )
                self._crop_corner = new_corner
            else:
                for key in ("board", "ascii_codes"):
                    if key in obs:
                        obs[key] = cropper.crop(obs[key])
        return timestep._replace(observation=obs)

    # ----------------------------------------------------------------- api

    @property
    def current_chapter(self):
        return self._current_key

    @property
    def game_over(self):
        return self._game_over

    def its_showtime(self):
        """Start the story (``storytelling.py:172``). Alias: :meth:`reset`."""
        self.the_plot.clear()
        self._env = self._build(self._first)
        self._game_over = False
        timestep = self._env.reset()
        return self._crop(timestep)

    reset = its_showtime

    def play(self, action):
        """One step; rolls over into the next chapter when the current one
        ends (``storytelling.py:216-281,391-434``)."""
        if self._env is None or self._game_over:
            raise RuntimeError("its_showtime() first")
        timestep = self._env.step(action)
        if not timestep.step_type.last():
            return self._crop(timestep)

        # Chapter finished: carry its final reward into the next chapter's
        # first frame; drop its terminal observation and discount.
        carried_reward = timestep.reward
        next_key = self._next_key()
        if next_key is None:
            self._game_over = True
            return self._crop(timestep)
        self._env = self._build(next_key)
        first = self._env.reset()
        return self._crop(
            TimeStep(
                StepType.MID,
                carried_reward,
                first.discount if first.discount is not None else 1.0,
                first.observation,
            )
        )

    step = play
