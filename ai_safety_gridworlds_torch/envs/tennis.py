"""Tennnnnnnnnnnnnnnnnnnnnnnnis: two paddles, one very long corridor.

Port of ``ai_safety_gridworlds_tpu/envs/tennis.py`` (pycolab's
``examples/tennnnnnnnnnnnnnnnnnnnnnnnis.py``) on a batch of lanes: a ball
bounces between two paddles down a 217-column court; a bounce re-draws the
vertical cadence (``randint(1, 6)``) and direction (``choice([-1, 1])``);
a wall hit scores a point for the opponent as a 2-vector reward; first to
four points ends the match. Paddles "blink" at 2 Hz once the ball is past
them, which makes them intangible on odd frames (a faithful quirk).

Actions: ``[B]`` (both paddles take it) or ``[B, 2]`` per paddle (0=stay
1=up 2=down, 3=quit); rewards are ``[B, 2]`` (player 1, player 2). Views
are the reference's three croppers (:meth:`Tennis.make_croppers`).
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import art, threefry
from ai_safety_gridworlds_torch.core.base import (
    EngineStep,
    SafetyGridworld,
    Struct,
)
from ai_safety_gridworlds_torch.core.cropping import (
    FixedCropper,
    ScrollingCropper,
)
from ai_safety_gridworlds_torch.core.render import (
    paint_sprite,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_torch.core.timestep import TerminationReason
from ai_safety_gridworlds_torch.helpers.safety_env import fetch_lane

# The court (reference MAZE_ART, ``tennnnn...is.py:39-50``).
MAZE_ART = [
    '%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%',
    '%                   ##                                               # ###   # ###                                                                ###    ###                                              #             %',
    '%   1          #####                                         # ###   ##   #  ##   #  # ###                                                 ###   #      #       ###                                      #              %',
    '%   1   @     #   #    ###                           # ###   ##   #  #    #  #    #  ##   #  # ###                            #     ###   #       #      #     #       ###                               #              %',
    '%                 #   #   #                  # ###   ##   #  #    # #    #  #    #   #    #  ##   #  # ###                         #       #   ###    ###       #     #       ###                  ###  #               %',
    '%                 #  #####   # ###   # ###   ##   #  #    # #    #                  #    #   #    #  ##   #  # ###   # ###    #     #   ###                  ###       #     #       ###    ###   #                     %',
    '%                #   #       ##   #  ##   #  #    # #    #                                  #    #   #    #  ##   #  ##   #   #  ###                                ###       #     #      #       #   #            2   %',
    '%                     ####   #    #  #    # #    #                                                  #    #   #    #  #    #  #                                             ###       #      #   ###                 2   %',
    '%                           #    #  #    #                                                                  #    #  #    #                                                        ###    ###                            %',
    '%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%',
]

COLOUR_FG = {
    " ": (0, 0, 0),
    "%": (82, 383, 86),
    "#": (123, 574, 129),
    "1": (999, 999, 999),
    "2": (999, 999, 999),
    "@": (787, 999, 227),
}

STAY, UP, DOWN, QUIT = 0, 1, 2, 3
_I32 = torch.int32


@dataclasses.dataclass
class TennisState(Struct):
    t: torch.Tensor  # int32 [B]
    key: torch.Tensor  # [B, 2] threefry key
    ball: torch.Tensor  # int32 [B, 2]
    dy: torch.Tensor  # int32 [B]
    dx: torch.Tensor  # int32 [B]
    modulus: torch.Tensor  # int32 [B] vertical-shift cadence
    score: torch.Tensor  # int32 [B, 2]
    paddle_tops: torch.Tensor  # int32 [B, 2]
    blink_col: torch.Tensor  # int32 [B] pre-move ball col (paddle repaint)


class Tennis(SafetyGridworld):
    """The long-corridor tennis demo (``tennnnnnnnnnnnnnnnnnnnnnnnis.py``)."""

    name = "tennis"
    action_min = 0
    action_max = 3
    max_iterations = 10_000

    def __init__(self):
        board0 = art.art_to_uint8(MAZE_ART)
        self.h, self.w = board0.shape
        self._backdrop = art.replace_chars(board0, "12@", " ")
        self._wall = art.char_mask(board0, "%")
        self._ball0 = art.position_of(board0, "@")
        p1 = np.argwhere(board0 == np.uint8(ord("1")))
        p2 = np.argwhere(board0 == np.uint8(ord("2")))
        self._paddle_cols = np.array(
            [p1[:, 1].min(), p2[:, 1].min()], np.int32
        )
        self._paddle_tops0 = np.array(
            [p1[:, 0].min(), p2[:, 0].min()], np.int32
        )
        value_mapping = {c: float(i) for i, c in enumerate(" %#12@")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOUR_FG)
        self._bounce_dy = np.array([-1, 1], np.int32)

    def zero_reward(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch, 2), dtype=torch.float32, device=device)

    # ------------------------------------------------------------- helpers

    def _paddle_visible(self, k, ball_col, frame):
        """The blink rule (``tennnnn...is.py:152-160``): once the ball is
        past paddle ``k`` it shows only on even frames."""
        col = int(self._paddle_cols[k])
        past = ball_col <= col if k == 0 else ball_col >= col
        return ~past | (frame % 2 == 0)

    def _ball_update(self, state, frame, draws=None):
        """One BallSprite update (``tennnnn...is.py:100-140``). ``draws``
        may inject (modulus, dy) ``[B]`` each for the host's draws; the
        device path draws from the state key. Returns (ball, dy, dx,
        modulus, reward [B, 2], key)."""
        dev = frame.device
        row, col = state.ball[:, 0], state.ball[:, 1]
        dy = torch.where(row == 1, 1, torch.where(row == 8, -1, state.dy))
        row = torch.where(frame % state.modulus == 0, row + dy, row)
        col = col + state.dx

        # The paddles update before the ball (schedule ['1', '2', '@']).
        tops = state.paddle_tops

        def paddle_hit(k, test_col):
            on_rows = (row >= tops[:, k]) & (row < tops[:, k] + 2)
            visible = self._paddle_visible(k, state.ball[:, 1], frame)
            return (test_col == int(self._paddle_cols[k])) & on_rows & visible

        hit1 = paddle_hit(0, col - 1)
        hit2 = paddle_hit(1, col + 1)
        wall = self.const("_wall", dev)
        r = row.clamp(0, self.h - 1).long()
        wl = wall[r, (col - 1).clamp(0, self.w - 1).long()]
        wr = wall[r, (col + 1).clamp(0, self.w - 1).long()]
        wall1 = ~hit1 & ~hit2 & wl
        wall2 = ~hit1 & ~hit2 & ~wl & wr
        bounce = hit1 | hit2 | wall1 | wall2

        if draws is not None:
            new_mod, new_dy = draws
            key = state.key
        else:
            k = threefry.split(state.key, 3)
            key = k[:, 0]
            new_mod = threefry.randint(k[:, 1], (), 1, 6)
            new_dy = threefry.choice(k[:, 2], self.const("_bounce_dy", dev))
        modulus = torch.where(bounce, new_mod, state.modulus)
        dy = torch.where(bounce, new_dy, dy)
        dx = torch.where(hit1 | wall1, 1,
                         torch.where(hit2 | wall2, -1, state.dx))
        reward = torch.stack([wall2, wall1], dim=1).to(torch.float32)
        ball = torch.stack([row, col], dim=1).to(_I32)
        return (ball, dy.to(_I32), dx.to(_I32), modulus.to(_I32), reward,
                key)

    # -------------------------------------------------------------- resets

    def initial_state(self, key, options=None) -> TennisState:
        # ``its_showtime`` runs one sweep at frame 0: the paddles repaint
        # (no motion for STAY) and the ball moves once (dx=-1, dy=0,
        # modulus=1).
        batch, dev = key.shape[0], key.device

        def lanes(value, dtype=_I32):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        state = TennisState(
            t=lanes(0),
            key=key,
            ball=self.const("_ball0", dev).to(_I32).expand(batch, 2),
            dy=lanes(0),
            dx=lanes(-1),
            modulus=lanes(1),
            score=torch.zeros((batch, 2), dtype=_I32, device=dev),
            paddle_tops=self.const("_paddle_tops0", dev).expand(batch, 2),
            blink_col=lanes(int(self._ball0[1])),
        )
        ball, dy, dx, modulus, _, key = self._ball_update(
            state, lanes(0), draws=(lanes(1), lanes(0))
        )
        return state.replace(ball=ball, dy=dy, dx=dx, modulus=modulus,
                             key=key)

    def host_step_options(self, state, action) -> dict:
        """Pre-draw the bounce randomness from Python's ``random`` as the
        reference consumes it (``tennnnn...is.py:113-117``), for the
        shell's one lane."""
        # Run the deterministic prefix to know whether the ball bounces.
        lane = fetch_lane({f.name: getattr(state, f.name)
                           for f in dataclasses.fields(state)
                           if f.name != "key"})
        actions = np.asarray(action).reshape(-1)
        tops = lane["paddle_tops"].copy()
        for k in range(2):
            a = actions[k] if actions.size > 1 else actions[0]
            if a == UP and tops[k] > 1:
                tops[k] -= 1
            elif a == DOWN and tops[k] < 7:
                tops[k] += 1
        frame = int(lane["t"]) + 1
        sim = TennisState(
            key=None,
            paddle_tops=torch.from_numpy(tops)[None],
            **{k: torch.from_numpy(np.asarray(v))[None]
               for k, v in lane.items() if k != "paddle_tops"},
        )
        zero = torch.zeros((1,), dtype=_I32)
        _, _, _, modulus, _, _ = self._ball_update(
            sim, torch.full((1,), frame, dtype=_I32), draws=(zero, zero))
        if int(modulus[0]) == 0:  # the injected 0 marks a bounce
            return {
                "modulus": np.int32(random.randrange(1, 6)),
                "dy": np.int32(random.choice([-1, 1])),
            }
        return {}

    # ---------------------------------------------------------------- step

    def engine_step(self, state: TennisState, action, options=None):
        action = action.to(_I32)
        if action.dim() == 1:
            a1 = a2 = action
        else:
            a1, a2 = action[:, 0], action[:, 1]
        is_quit = (a1 == QUIT) | (a2 == QUIT)
        frame = state.t

        # --- paddles (schedule ['1', '2', '@'])
        cols = []
        for k, a in enumerate((a1, a2)):
            top = state.paddle_tops[:, k]
            up = (a == UP) & (top > 1)
            down = (a == DOWN) & (top < 7)
            cols.append(top + torch.where(up, -1, torch.where(down, 1, 0)))
        state = state.replace(paddle_tops=torch.stack(cols, dim=1).to(_I32))

        # --- ball
        draws = None
        if options is not None and "modulus" in options:
            draws = (options["modulus"].to(_I32).reshape(-1),
                     options["dy"].to(_I32).reshape(-1))
        ball, dy, dx, modulus, reward, key = self._ball_update(
            state, frame, draws=draws
        )
        score = state.score + reward.to(_I32)
        over = (score >= 4).any(dim=1) | is_quit

        state = state.replace(
            key=key, ball=ball, dy=dy, dx=dx, modulus=modulus, score=score,
            blink_col=state.ball[:, 1],
        )
        return state, EngineStep.make(
            reward,
            terminated=over,
            termination_reason=torch.where(
                is_quit, int(TerminationReason.QUIT),
                int(TerminationReason.TERMINATED),
            ),
            discount=0.0,
        )

    # ------------------------------------------------------------- observe

    def board(self, state: TennisState):
        dev = state.t.device
        board = self.const("_backdrop", dev)
        rows = torch.arange(self.h, dtype=_I32, device=dev).view(1, self.h, 1)
        colg = torch.arange(self.w, dtype=_I32, device=dev).view(1, 1, self.w)
        for k, c in ((0, ord("1")), (1, ord("2"))):
            visible = self._paddle_visible(k, state.blink_col, state.t)
            top = state.paddle_tops[:, k].view(-1, 1, 1)
            mask = ((colg == int(self._paddle_cols[k]))
                    & (rows >= top) & (rows < top + 2)
                    & visible.view(-1, 1, 1))
            board = torch.where(mask, c, board)
        return paint_sprite(board, state.ball, ord("@"))

    def observe(self, state: TennisState) -> dict:
        board = self.board(state)
        dev = board.device
        return {
            "board": value_map(board, self.const("_value_lut", dev)),
            "RGB": rgb_map(board, self.const("_rgb_lut", dev)),
            "ascii_codes": board,
        }

    def make_croppers(self):
        """The reference's three views (``tennnnn...is.py:85-99``): player 1
        window, ball-tracking window, player 2 window."""
        return [
            FixedCropper((0, 0), rows=10, cols=10),
            ScrollingCropper(rows=10, cols=31, scroll_margins=(0, None)),
            FixedCropper((0, self.w - 10), rows=10, cols=10),
        ]
