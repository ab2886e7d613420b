"""Extraterrestrial Marauders: a Space-Invaders-style demo game.

Port of ``ai_safety_gridworlds_tpu/envs/extraterrestrial_marauders.py``
(pycolab's ``examples/extraterrestrial_marauders.py``) on a batch of lanes:
a lockstep marauder formation marches sideways (faster as it thins,
reversing and descending at the screen edges), bunkers erode under fire
(-1 per hit), player bolts destroy marauders (+10), marauder bolts kill
the player; the game ends when the formation is wiped out, reaches row 10,
or the player is hit.

Actions: 0=left 1=right 2=fire 3=stay 4=quit. Up to 4 player bolts and 2
marauder bolts fly at once (hidden bolts park at row -1).

Each frame one marauder bolt may fire from a column drawn with
``threefry.choice(p=)``, the weights those of the columns that hold a
marauder (their running sums added in XLA's order, so the draw is JAX's).
``shoot_gaps`` (a list, None by default) collects each draw's per-lane
distance from a running sum in ulps (``threefry.choice_gap``): one entry
from every ``initial_state`` and one from every ``engine_step`` that
draws; a draw within a few ulps is one that sums rounded in another order
could move.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import art, threefry
from ai_safety_gridworlds_torch.core.base import (
    EngineStep,
    SafetyGridworld,
    Struct,
)
from ai_safety_gridworlds_torch.core.render import (
    paint_sprite,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_torch.core.timestep import TerminationReason

GAME_ART = [
    "    X   X   X   X   X   X   X   X      ",
    "     X   X   X   X   X   X   X   X     ",
    "    X   X   X   X   X   X   X   X      ",
    "     X   X   X   X   X   X   X   X     ",
    "    X   X   X   X   X   X   X   X      ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "                                       ",
    "  P                                    ",
]

N_UP_BOLTS = 4
N_DOWN_BOLTS = 2
_DOOM_ROW = 10

COLOURS = {
    " ": (0, 0, 0),
    "X": (999, 999, 999),
    "B": (400, 50, 30),
    "P": (0, 999, 0),
    "^": (0, 999, 999),
    "|": (0, 999, 999),
}

_I32 = torch.int32


@dataclasses.dataclass
class MaraudersState(Struct):
    t: torch.Tensor  # int32 [B]
    key: torch.Tensor  # [B, 2] threefry key
    player_col: torch.Tensor  # int32 [B]
    marauders: torch.Tensor  # bool [B, H, W]
    bunkers: torch.Tensor  # bool [B, H, W]
    up_bolts: torch.Tensor  # int32 [B, N_UP, 2], row -1 = hidden
    down_bolts: torch.Tensor  # int32 [B, N_DOWN, 2]
    dx: torch.Tensor  # int32 [B] marauder horizontal direction


def _roll_cols(m, dx):
    """Each lane's ``[H, W]`` mask rolled by its ``dx`` (+1 or -1) along
    the columns, with wraparound."""
    right = dx.view(-1, 1, 1) == 1
    return torch.where(right, torch.roll(m, 1, dims=2),
                       torch.roll(m, -1, dims=2))


class ExtraterrestrialMarauders(SafetyGridworld):
    """Lockstep alien formation vs one player
    (``extraterrestrial_marauders.py``)."""

    name = "extraterrestrial_marauders"
    action_min = 0
    action_max = 4
    max_iterations = 2000
    shoot_gaps = None

    def __init__(self):
        board0 = art.art_to_uint8(GAME_ART)
        self.h, self.w = board0.shape
        self._marauders0 = art.char_mask(board0, "X")
        self._bunkers0 = art.char_mask(board0, "B")
        self._player0 = art.position_of(board0, "P")
        value_mapping = {" ": 0.0, "X": 1.0, "B": 2.0, "P": 3.0,
                         "^": 4.0, "|": 5.0}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)
        self._rows = np.arange(self.h, dtype=np.int32)
        self._blank = np.full((self.h, self.w), ord(" "), np.uint8)

    # ------------------------------------------------------------- helpers

    def _shooter(self, sub, marauders, options):
        """The column a marauder bolt fires from (drawn over the columns
        that hold a marauder, or the ``shooter_col`` test hook) and the
        bolt's start row, one below the column's lowest marauder (0 for an
        empty column)."""
        if options is not None and "shooter_col" in options:
            # Test hook: the reference's host-random shooter column.
            shooter_col = options["shooter_col"].to(_I32).reshape(-1)
            shooter_col = shooter_col.expand(marauders.shape[0])
        else:
            col_weights = marauders.any(dim=1).to(torch.float32)
            p = col_weights / torch.clamp(col_weights.sum(dim=1), min=1.0)[
                :, None]
            shooter_col = threefry.choice(sub, self.w, p=p)
            if self.shoot_gaps is not None:
                self.shoot_gaps.append(threefry.choice_gap(sub, p))
        column = marauders.gather(
            2, shooter_col.long().view(-1, 1, 1).expand(-1, self.h, 1)
        )[:, :, 0]
        rows = self.const("_rows", marauders.device)
        shooter_row = torch.where(column, rows, -1).amax(dim=1)
        return torch.stack([shooter_row + 1, shooter_col], dim=1).to(_I32)

    def _bolt_mask(self, bolts):
        """bool ``[B, H, W]``: the cells of each lane's visible bolts
        (``bolts`` ``[B, n, 2]``, row -1 hidden)."""
        dev = bolts.device
        rows = torch.arange(self.h, dtype=_I32, device=dev).view(1, self.h, 1)
        cols = torch.arange(self.w, dtype=_I32, device=dev).view(1, 1, self.w)
        mask = torch.zeros((bolts.shape[0], self.h, self.w), dtype=torch.bool,
                           device=dev)
        for i in range(bolts.shape[1]):
            r = bolts[:, i, 0].view(-1, 1, 1)
            c = bolts[:, i, 1].view(-1, 1, 1)
            mask = mask | ((r >= 0) & (rows == r) & (cols == c))
        return mask

    def _cell(self, mask, bolts):
        """bool ``[B, n]``: ``mask`` at each bolt's cell (row clipped; the
        column of a hidden bolt clipped too, the caller masks it)."""
        r = bolts[:, :, 0].clamp(0, self.h - 1).long()
        c = bolts[:, :, 1].clamp(0, self.w - 1).long()
        lanes = torch.arange(mask.shape[0], device=mask.device)[:, None]
        return mask[lanes, r, c]

    def _at_edge(self, marauders):
        return (marauders[:, :, 0] | marauders[:, :, -1]).any(dim=1)

    # -------------------------------------------------------------- resets

    def initial_state(self, key, options=None) -> MaraudersState:
        # The showtime sweep (frame 0): the formation moves once and ONE
        # marauder bolt fires from below a random marauder of the PRE-move
        # formation (the bolts read the board as rendered at the end of
        # the previous frame).
        batch, dev = key.shape[0], key.device
        marauders = self.const("_marauders0", dev).expand(
            batch, self.h, self.w)
        k = threefry.split(key)
        key, sub = k[:, 0], k[:, 1]
        down = torch.full((batch, N_DOWN_BOLTS, 2), -1, dtype=_I32,
                          device=dev)
        down[:, 0] = self._shooter(sub, marauders, options)

        at_edge = self._at_edge(marauders)
        dx = torch.where(at_edge, 1, -1).to(_I32)
        marauders = torch.where(at_edge.view(-1, 1, 1),
                                torch.roll(marauders, 1, dims=1), marauders)
        marauders = _roll_cols(marauders, dx)
        return MaraudersState(
            t=torch.zeros((batch,), dtype=_I32, device=dev),
            key=key,
            player_col=torch.full((batch,), int(self._player0[1]),
                                  dtype=_I32, device=dev),
            marauders=marauders,
            bunkers=self.const("_bunkers0", dev).expand(
                batch, self.h, self.w).clone(),
            up_bolts=torch.full((batch, N_UP_BOLTS, 2), -1, dtype=_I32,
                                device=dev),
            down_bolts=down,
            dx=dx,
        )

    # ---------------------------------------------------------------- step

    def engine_step(self, state: MaraudersState, action, options=None):
        is_quit = action == 4
        up, down = state.up_bolts, state.down_bolts
        up_mask = self._bolt_mask(up)
        down_mask = self._bolt_mask(down)
        all_bolts = up_mask | down_mask

        # Bunker erosion: any bolt hit costs a point and consumes the bolt.
        bunker_hits = all_bolts & state.bunkers
        bunkers = state.bunkers & ~bunker_hits
        # Marauder kills: only player bolts.
        marauder_hits = up_mask & state.marauders
        marauders = state.marauders & ~marauder_hits
        reward = (-bunker_hits.sum(dim=(1, 2), dtype=_I32).to(torch.float32)
                  + 10.0 * marauder_hits.sum(dim=(1, 2), dtype=_I32))

        up_on = up[:, :, 0] >= 0
        up_gone = up_on & (self._cell(bunker_hits, up)
                           | self._cell(marauder_hits, up))
        down_gone = (down[:, :, 0] >= 0) & self._cell(bunker_hits, down)
        up = torch.where(up_gone[:, :, None], -1, up)
        down = torch.where(down_gone[:, :, None], -1, down)

        # Formation end conditions.
        wiped = ~marauders.any(dim=(1, 2))
        landed = marauders[:, _DOOM_ROW, :].any(dim=1)

        # Formation movement: speed scales with the remaining count;
        # floor(count / 8.0000001) in exact integer arithmetic.
        frame = state.t  # base.step already advanced to the current frame
        count = marauders.sum(dim=(1, 2), dtype=_I32)
        period = torch.clamp(count // 8 - (count % 8 == 0).to(_I32), min=1)
        moving = (frame % period) == 0
        at_edge = self._at_edge(marauders)
        turn = moving & at_edge
        dx = torch.where(turn, -state.dx, state.dx)
        marauders = torch.where(turn.view(-1, 1, 1),
                                torch.roll(marauders, 1, dims=1), marauders)
        marauders = torch.where(moving.view(-1, 1, 1),
                                _roll_cols(marauders, dx), marauders)

        # Player motion.
        step = torch.where(action == 0, -1, torch.where(action == 1, 1, 0))
        col = (state.player_col + step).clamp(0, self.w - 1).to(_I32)

        # Player bolts fly north; a hidden one spawns on fire.
        up_visible = up[:, :, 0] >= 0
        up_row = torch.where(up_visible, up[:, :, 0] - 1, up[:, :, 0])
        up = torch.stack([up_row, up[:, :, 1]], dim=2)
        up = torch.where((up[:, :, 0] < 0)[:, :, None], -1, up)
        fire = (action == 2) & ~is_quit
        # Eligible slots were invisible at the START of the frame.
        up_was_free = state.up_bolts[:, :, 0] < 0
        free_slot = up_was_free.to(_I32).argmax(dim=1)
        can_fire = fire & up_was_free.gather(1, free_slot[:, None])[:, 0]
        slot = torch.arange(N_UP_BOLTS, device=up.device) == free_slot[:, None]
        spawn = torch.stack([torch.full_like(col, self.h - 2), col], dim=1)
        up = torch.where((slot & can_fire[:, None])[:, :, None],
                         spawn[:, None, :], up)

        # Marauder bolts fly south; a hidden one fires from a random
        # marauder's column each step.
        player_row = self.h - 1
        down_visible = down[:, :, 0] >= 0
        hit_player = (down_visible & (down[:, :, 0] == player_row)
                      & (down[:, :, 1] == col[:, None])).any(dim=1)
        down_row = torch.where(down_visible, down[:, :, 0] + 1, down[:, :, 0])
        down = torch.stack([down_row, down[:, :, 1]], dim=2)
        down = torch.where((down[:, :, 0] >= self.h)[:, :, None], -1, down)

        k = threefry.split(state.key)
        key, sub = k[:, 0], k[:, 1]
        # The shooter comes from the PRE-hit, PRE-move formation.
        shot = self._shooter(sub, state.marauders, options)
        down_was_free = state.down_bolts[:, :, 0] < 0
        dfree = down_was_free.to(_I32).argmax(dim=1)
        dcan = down_was_free.gather(1, dfree[:, None])[:, 0] & ~wiped
        dslot = torch.arange(N_DOWN_BOLTS, device=down.device) == dfree[:, None]
        down = torch.where((dslot & dcan[:, None])[:, :, None],
                           shot[:, None, :], down)

        terminated = is_quit | wiped | landed | hit_player
        state = state.replace(
            key=key,
            player_col=col,
            marauders=marauders,
            bunkers=bunkers,
            up_bolts=up.to(_I32),
            down_bolts=down.to(_I32),
            dx=dx,
        )
        reason = torch.where(
            is_quit, int(TerminationReason.QUIT),
            torch.where(terminated, int(TerminationReason.TERMINATED),
                        int(TerminationReason.NONE)),
        )
        return state, EngineStep.make(
            reward,
            terminated=terminated,
            termination_reason=reason,
            discount=0.0,
            actual_action=action,
        )

    # ------------------------------------------------------------- observe

    def board(self, state):
        dev = state.t.device
        board = self.const("_blank", dev)
        board = torch.where(state.bunkers, ord("B"), board)
        board = torch.where(state.marauders, ord("X"), board)
        board = torch.where(self._bolt_mask(state.up_bolts), ord("^"), board)
        board = torch.where(self._bolt_mask(state.down_bolts), ord("|"),
                            board)
        player = torch.stack(
            [torch.full_like(state.player_col, self.h - 1), state.player_col],
            dim=1)
        return paint_sprite(board.to(torch.uint8), player, ord("P"))

    def observe(self, state) -> dict:
        board = self.board(state)
        dev = board.device
        return {
            "board": value_map(board, self.const("_value_lut", dev)),
            "RGB": rgb_map(board, self.const("_rgb_lut", dev)),
            "ascii_codes": board,
        }
