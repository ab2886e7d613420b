"""Terminal viewer for watching an agent play a gridworld live.

Port of ``ai_safety_gridworlds_tpu/helpers/agent_viewer.py``: ``AgentViewer``
over the port's stateful shells draws the current board, the episode
return and the pause-corrected elapsed time after each agent step. The frame
construction is pure (:func:`ai_safety_gridworlds_torch.ui.safety_ui.render_frame`)
so the viewer is testable without a terminal via :meth:`render`.
"""

from __future__ import annotations

import time
from typing import Optional

from ai_safety_gridworlds_torch.ui.safety_ui import (
    curses_colours,
    render_frame,
)


class AgentViewer:
    """Displays an agent's interactions with the environment in a terminal.

    Args:
      pause: seconds to sleep after each displayed frame (display pacing);
        the wall-clock time consumed by pausing is subtracted from the
        elapsed-time display.
      color_bg / color_fg: char -> (r, g, b) in 0-999, as in the games'
        ``GAME_BG_COLOURS`` / ``GAME_FG_COLOURS``.
      delay: curses input timeout in ms (None blocks).
      headless: skip curses initialisation; :meth:`display` then renders to
        ``self.last_frame`` only (used in tests / logging pipelines).
    """

    def __init__(
        self,
        pause: Optional[float] = None,
        color_bg: Optional[dict] = None,
        color_fg: Optional[dict] = None,
        delay: Optional[int] = None,
        headless: bool = False,
    ):
        self._pause = pause
        self._colour_bg = curses_colours(color_bg or {})
        self._colour_fg = curses_colours(color_fg or {})
        self._headless = headless
        self._screen = None
        self._pairs = {}
        self.last_frame: list = []
        if not headless:
            import curses

            self._screen = curses.initscr()
            curses.noecho()
            curses.cbreak()
            try:
                curses.curs_set(0)
            except curses.error:
                pass
            if delay is not None:
                self._screen.timeout(delay)
            if curses.has_colors() and self._colour_bg:
                curses.start_color()
                next_colour, next_pair = 16, 1
                for c, bg in sorted(self._colour_bg.items()):
                    if (
                        next_colour + 1 >= curses.COLORS
                        or next_pair >= curses.COLOR_PAIRS
                    ):
                        break
                    fg = self._colour_fg.get(c, (0, 0, 0))
                    try:
                        curses.init_color(next_colour, *bg)
                        curses.init_color(next_colour + 1, *fg)
                        curses.init_pair(
                            next_pair, next_colour + 1, next_colour
                        )
                        self._pairs[c] = curses.color_pair(next_pair)
                    except curses.error:
                        break
                    next_colour += 2
                    next_pair += 1
        self.reset_time()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        if self._screen is not None:
            import curses

            curses.endwin()
            self._screen = None

    # ------------------------------------------------------------- display

    def render(self, env, timestep=None) -> list:
        """Build and store the current frame without touching the screen."""
        self.last_frame = render_frame(
            env, timestep, elapsed=self._get_elapsed()
        )
        return self.last_frame

    def display(self, env, timestep=None):
        """Redraw the board, score, and elapsed time after an agent step."""
        frame = self.render(env, timestep)
        if self._screen is not None:
            self._screen.erase()
            for y, row in enumerate(frame):
                for x, ch in enumerate(row):
                    try:
                        self._screen.addstr(
                            y, x, ch, self._pairs.get(ch, 0)
                        )
                    except Exception:
                        pass
            self._screen.refresh()
        self._do_pause()

    # ------------------------------------------------------------- timing

    def reset_time(self):
        self._start_time = time.time()
        self._pause_cnt = 0

    def _do_pause(self):
        if self._pause is not None:
            time.sleep(self._pause)
            self._pause_cnt += 1

    def _get_elapsed(self) -> float:
        s = 0.0 if self._pause is None else float(self._pause)
        return time.time() - self._start_time - s * self._pause_cnt
