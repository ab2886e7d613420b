"""Better Scrolly Maze: explore a big maze through cropped views.

Port of ``ai_safety_gridworlds_tpu/envs/better_scrolly_maze.py`` (pycolab's
``examples/better_scrolly_maze.py``) on a batch of lanes: the engine
renders the WHOLE maze, and "scrolling" is pure observation cropping.
Patrollers wander horizontally every other frame, reversing at walls, and
end the episode on contact with the player; coins pay +100 each and
collecting them all wins. Three levels (45 x 89, 29 x 30, 29 x 89). Views
come from :meth:`BetterScrollyMaze.make_croppers` (player-tracking,
patroller-tracking, fixed teaser window).

Actions: 0=up 1=down 2=left 3=right 4=stay 5=quit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import art
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

MAZES_ART = [
    [
        '#########################################################################################',
        '#       #               #       #           #           #  @   @   @   @    # @   @   @ #',
        '#   #   #####   #####   #   #   #####   #   #   #####   #############   # @ #########   #',
        '# @ #   #       #   #       #           #       #       #           # @ #    @   @   @  #',
        '#   #####   #####   #########   #################   #####   #   #   #   #################',
        '#   #       #     @    @    #           #       #           #   #   #                   #',
        '# @ #   #   # @ #########   #####   #   #   #   #########   #####   #   #############   #',
        '#   #   #   #     @ # @   @ #       #   #   #           #   #       #   #       #       #',
        '#   #   #############   #####   #########   #   #####   #####   #####   #   #   #########',
        '# @     # @   @   @ #   #       #       # @ #       #       # a             #           #',
        '#   #####   #####   # @ #   #####   #   #   #############   #   #####################   #',
        '#   # @   @ #   #   #   #           #   #   @   @   #       #   #  @    @    @   @  #   #',
        '# @ #   #####   # @ #   #####   #####   #########   #   #####   #####   #########   #####',
        '#   #   #       #     @ #   #       #       # @   @ #       #           #       #  @    #',
        '#   # @ #   #   #########   #####   #########   #############################   ##### @ #',
        '# @ #   #   #   #       #                   #   #           #           #       # @ #   #',
        '#   #   #   #   #   #   #################   # @ #   #####   #   #########   #####   #   #',
        '#     @ #   #       #       #           #   #       #   #   #           #   #   @   # @ #',
        '#########   #############   #   #####   #   #   #####   #   #########   #   #   #####   #',
        '#       #   #           #   #       #   #   # @ #           #       #   #     @ # @     #',
        '#   #   #############   #   #########   #   #   #   #########   #   #   #   #   ##### @ #',
        '#   #           #       # b                 #   #   #       #   #       #   #   @   #   #',
        '#   #########   #   #########   #   #   #####   #   #   #####   #####   #   #####   #   #',
        '#   #   #     @ #               # P #           #   #           #       #       # @ # @ #',
        '#   #   # @ #####################################   #   #####################   #   #   #',
        '#   #   #     @     #   @   #   #                   #   #                       #   @   #',
        '#   #   ######### @ #   #   #   #   #################   #########   #########   #########',
        '#   #   #       #     @ # @ #       #               #               #       #   #       #',
        '#   #   #####   #############   #########   #####   #################   #   #   #####   #',
        '#       #       #           #       #       #       #           #       #   #       #   #',
        '#   #####   #############   #####   #   #####   #####   #####   #   #############   #   #',
        '#       #           #       #   #       #       #       #       #           #           #',
        '#####   #   #########   #####   #########   #############   #   #########   #   #########',
        '#               #       # @ #           #   #           #   #       #           #       #',
        '#   #############   #####   #   #####   #   #   #####   #   #####   #   #   #####   #   #',
        '#       # @         #   @   #       #       #   #       #       #       #           #   #',
        '#####   #   #########   #########   #########   #####################################   #',
        '#       #   #   @   # @ #  @  @ #               # @    @    @   @   #     @ #  @  @ #   #',
        '#   ##### @ #   #####   #   #####   #############   #########   #   # @ #   #   #####   #',
        '#   #   #     @    @    # @   @     #           #   @   # @ #   # @     #  @    #       #',
        '#   #   #####   #################   #   #   #   #####   #   #   #################   #####',
        '#   #       #    @    @     # @     #   #   #       #  @    #   #   #               #   #',
        '#   #####   #########   #   #   #   #####   #####   #########   #   #   #############   #',
        '#                       # @     #           #       # c                                 #',
        '#########################################################################################',
    ],
    [
        '##############################',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#                            #',
        '#########  a         #########',
        '##########        b ##########',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#                            #',
        '#######       c        #######',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#              P             #',
        '##############################',
    ],
    [
        '                                                                                         ',
        '   ###################################################################################   ',
        '   #  @  @  @  @  @  @  @  @  @  @           P                                       #   ',
        '   #   ###########################################################################   #   ',
        '   # @ #                                                                         #   #   ',
        '   #   #                                                                         #   #   ',
        '   # @ #                    ######################################################   #   ',
        '   #   #                    #                                                        #   ',
        '   # @ #                    #   ######################################################   ',
        '   #   #                    #   #                                                        ',
        '   # @ #                    #   #                                                        ',
        '   #   #                    #   ######################################################   ',
        '   # @ #                    #                                                        #   ',
        '   #   #                    ######################################################   #   ',
        '   # @ #                                                                         #   #   ',
        '   #   #                                                                         #   #   ',
        '   # @ #                                            ##############################   #   ',
        '   #   #                                           ##                            #   #   ',
        '   # @ #                                           #      @@@@@      #########   #   #   ',
        '   #   #                                           #   @@@@@@@@@@@   #       #   #   #   ',
        '   # @ ###########                                ##@@@@@@@@@@@@@@@@@##      #   #   #   ',
        '   #   # @  @  @ #                               ##@@@@@@@@@@@@@@@@@@@##     #   #   #   ',
        '   # @ #  a      #                              ##@@@@@@@@@@@@@@@@@@@@@##    #   #   #   ',
        '   #   #    b    #                             ##@@@@@@@@@@@@@@@@@@@@@@@##   #   #   #   ',
        '   # @ #      c  #                             ##@@@@@@@@@@@@@@@@@@@@@@@##   #   #   #   ',
        '   #   #######   #                              ##@@@@@@@@@@@@@@@@@@@@@##    #   #   #   ',
        '   # @  @  @     #                               ##@@@@@@@@@@@@@@@@@@@##     #       #   ',
        '   ###############                                #####################      #########   ',
        '                                                                                         ',
    ],
]

TEASER_CORNER = [(3, 9), (4, 5), (16, 53)]
STARTER_OFFSET = [(-2, -12), (10, 0), (-3, 0)]

COLOUR_FG = {
    " ": (0, 0, 0),
    "@": (999, 862, 110),
    "#": (764, 0, 999),
    "P": (0, 999, 999),
    "a": (999, 0, 780),
    "b": (145, 987, 341),
    "c": (987, 623, 145),
}

PATROLLERS = "abc"

_I32 = torch.int32
# Action -> (drow, dcol); 4 (stay), 5 (quit) and any other do not move.
_DELTAS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0], [0, 0]],
                   np.int32)


@dataclasses.dataclass
class BetterScrollyMazeState(Struct):
    t: torch.Tensor  # int32 [B]
    key: torch.Tensor  # [B, 2] threefry key (the game draws nothing)
    pos: torch.Tensor  # int32 [B, 2] player
    patrollers: torch.Tensor  # int32 [B, 3, 2]
    moving_east: torch.Tensor  # bool [B, 3]
    coins: torch.Tensor  # bool [B, H, W]
    caught: torch.Tensor  # bool [B] player caught at the showtime sweep


class BetterScrollyMaze(SafetyGridworld):
    """The cropping-based scrolling maze (``better_scrolly_maze.py``)."""

    name = "better_scrolly_maze"
    action_min = 0
    action_max = 5
    max_iterations = 10_000

    def __init__(self, level=0):
        self.level = level
        board0 = art.art_to_uint8(MAZES_ART[level])
        self.h, self.w = board0.shape
        self._pos0 = art.position_of(board0, "P")
        self._patrollers0 = np.stack(
            [art.position_of(board0, c) for c in PATROLLERS]
        )
        self._east0 = np.array([bool(ord(c) % 2) for c in PATROLLERS])
        self._backdrop = art.replace_chars(board0, "P@abc", " ")
        self._wall = art.char_mask(board0, "#")
        self._coins0 = art.char_mask(board0, "@")
        value_mapping = {c: float(i) for i, c in enumerate(" #@Pabc")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOUR_FG)
        self._deltas = _DELTAS

    # -------------------------------------------------------------- helpers

    def _wall_at(self, r, c):
        """The wall mask at each lane's (clipped) cell."""
        wall = self.const("_wall", r.device)
        return wall[r.clamp(0, self.h - 1).long(),
                    c.clamp(0, self.w - 1).long()]

    def _patroller_sweep(self, patrollers, moving_east, frame, player_pos):
        """One patroller update for all three (``:285-301``): move on even
        frames, reverse at adjacent walls, catch the player on contact."""
        even = frame % 2 == 0
        caught = torch.zeros_like(even)
        cols, dirs = [], []
        for k in range(3):
            r, c = patrollers[:, k, 0], patrollers[:, k, 1]
            east = torch.where(
                self._wall_at(r, c + 1), False,
                torch.where(self._wall_at(r, c - 1), True,
                            moving_east[:, k]))
            target_c = c + torch.where(east, 1, -1)
            blocked = self._wall_at(r, target_c)
            moved_c = torch.where(even & ~blocked, target_c, c)
            cols.append(moved_c)
            dirs.append(torch.where(even, east, moving_east[:, k]))
            caught = caught | (even & (r == player_pos[:, 0])
                               & (moved_c == player_pos[:, 1]))
        pat = torch.stack(
            [patrollers[:, :, 0], torch.stack(cols, dim=1)], dim=2)
        return pat.to(_I32), torch.stack(dirs, dim=1), caught

    # --------------------------------------------------------------- resets

    def initial_state(self, key, options=None) -> BetterScrollyMazeState:
        # ``its_showtime`` runs one sweep at frame 0 (even): the patrollers
        # move.
        batch, dev = key.shape[0], key.device
        t = torch.zeros((batch,), dtype=_I32, device=dev)
        pos = self.const("_pos0", dev).expand(batch, 2)
        pat, east, caught = self._patroller_sweep(
            self.const("_patrollers0", dev).expand(batch, 3, 2),
            self.const("_east0", dev).expand(batch, 3),
            t, pos,
        )
        return BetterScrollyMazeState(
            t=t,
            key=key,
            pos=pos,
            patrollers=pat,
            moving_east=east,
            coins=self.const("_coins0", dev).expand(batch, self.h, self.w),
            caught=caught,
        )

    # ----------------------------------------------------------------- step

    def engine_step(self, state: BetterScrollyMazeState, action,
                    options=None):
        is_quit = action == 5
        # Patrollers move first (schedule ['a','b','c','P','@']), catching
        # the player at its PRE-move position.
        pat, east, caught = self._patroller_sweep(
            state.patrollers, state.moving_east, state.t, state.pos
        )
        caught = caught | state.caught

        # The player: a MazeWalker (impassable '#').
        dev = action.device
        known = (action >= 0) & (action <= 5)
        delta = self.const("_deltas", dev)[
            torch.where(known, action, 4).long()]
        target = state.pos + delta
        in_b = ((target[:, 0] >= 0) & (target[:, 0] < self.h)
                & (target[:, 1] >= 0) & (target[:, 1] < self.w))
        blocked = self._wall_at(target[:, 0], target[:, 1]) & in_b
        pos = torch.where(blocked[:, None], state.pos, target).to(_I32)

        # Coins (``:311-320``).
        lanes = torch.arange(pos.shape[0], device=dev)
        rr = pos[:, 0].clamp(0, self.h - 1).long()
        cc = pos[:, 1].clamp(0, self.w - 1).long()
        on_coin = state.coins[lanes, rr, cc] & in_b
        coins = state.coins.clone()
        coins[lanes, rr, cc] = state.coins[lanes, rr, cc] & ~on_coin
        all_collected = ~coins.any(dim=(1, 2))

        state = state.replace(
            pos=pos,
            patrollers=pat,
            moving_east=east,
            coins=coins,
            caught=torch.zeros_like(caught),
        )
        return state, EngineStep.make(
            torch.where(on_coin, 100.0, 0.0),
            terminated=caught | all_collected | is_quit,
            termination_reason=torch.where(
                is_quit, int(TerminationReason.QUIT),
                int(TerminationReason.TERMINATED),
            ),
            discount=0.0,
        )

    # -------------------------------------------------------------- observe

    def board(self, state: BetterScrollyMazeState):
        board = self.const("_backdrop", state.pos.device)
        # z-order 'abc@P'.
        for k, c in enumerate(PATROLLERS):
            board = paint_sprite(board, state.patrollers[:, k], ord(c))
        board = torch.where(state.coins, ord("@"), board)
        return paint_sprite(board, state.pos, ord("P"))

    def observe(self, state: BetterScrollyMazeState) -> dict:
        board = self.board(state)
        dev = board.device
        return {
            "board": value_map(board, self.const("_value_lut", dev)),
            "RGB": rgb_map(board, self.const("_rgb_lut", dev)),
            "ascii_codes": board,
        }

    def make_croppers(self):
        """The reference's three views (``better_scrolly_maze.py:224-247``)."""
        return [
            ScrollingCropper(
                rows=10, cols=30,
                initial_offset=STARTER_OFFSET[self.level],
            ),
            ScrollingCropper(
                rows=7, cols=10, pad_char=" ", scroll_margins=(None, 3)
            ),
            FixedCropper(
                TEASER_CORNER[self.level], rows=12, cols=20, pad_char=" "
            ),
        ]
