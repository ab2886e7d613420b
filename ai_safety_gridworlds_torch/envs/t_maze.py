"""T-maze: cue, teleport through limbo, pick the cued arm.

Port of ``ai_safety_gridworlds_tpu/envs/t_maze.py`` (pycolab's
``examples/research/lp-rnn/t_maze.py``, the third lp-rnn memory task) on a
batch of lanes: the agent sees a
left/right cue in a small chamber, walks onto a teleporter that appears
after a delay, is frozen in a "limbo" cell for a time, then lands in one of
six T-mazes (difficulty = maze size) and must reach the cued goal arm
(+1/-1; -0.001 per frame; configurable timeout).

This game is the reference's showcase of the full Scrolly machinery
(``prefab_parts/drapes.py:487-659`` + ``protocols/scrolling.py:287-532``),
so the functional rebuild models that protocol exactly, one frame per
``engine_step``:

* All five Scrolly drapes share one window CORNER (clamped to the pattern,
  ``drapes.py:564-578``) plus a cumulative pattern ROLL (the
  ``PseudoTeleportingScrolly`` ``np.roll`` teleports, ``t_maze.py:315-331``).
* The scroll-permission handshake: the player declares which cardinal
  motions are legal for the NEXT frame from the MID-FRAME board
  (``sprites.py:459-477``) — walls already scrolled by update group 0,
  goal/teleporter curtains lagging one frame (they update in group 2,
  ``t_maze.py:210``), cue overlay current. Lagging overlay curtains
  therefore mask walls, which is observable reference behaviour.
* The player is a full egocentric MazeWalker: it obeys the (possibly
  clamped) scroll order by moving ``-order`` on screen, then applies its
  own motion only if the mid-frame board allows (``sprites.py:356-390``),
  so its screen position can drift off centre and even off the board
  (virtual positions, true position pinned to (0, 0) while off board).
* Quit (0/6) is ignored during teleport order-hold frames
  (``t_maze.py:232-245``), and skipping the move means no permissions are
  declared for the following frame.
* Goals check the player's true position against the PRE-scroll corner in
  the post-roll pattern (``pattern_position_prescroll``, ``t_maze.py:487``);
  the teleporter checks the POST-scroll corner (``t_maze.py:447``).

Actions: 1=up 2=down 3=left 4=right 5=stay 0/6=quit (``t_maze.py:524-528``).

Each lane carries its own speckle pattern (bool ``[77, 191]``, 14,707
cells), drawn per episode: on the device by
:meth:`TMaze.sample_reset_options` (a ``randint`` and a ``[77, 191]``
``uniform``), or on the host by :meth:`TMaze.host_reset_options` (Python's
``random``, then numpy's global RNG) for the stateful shell.
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
from ai_safety_gridworlds_torch.core.render import (
    char_repainter_lut,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_torch.core.scrolling import (
    ScrollingWorld,
    pattern_info,
)
from ai_safety_gridworlds_torch.core.timestep import TerminationReason

MAZE_ART = [
    '                                                                                                                                                                                               ',
    '                                                                                                                                       ##   #   ##                                             ',
    '                                                                                                                                         ## # ##                                               ',
    '                                                                                         +  #####                                          ###                                                 ',
    '                                                                                            #ttt#                                      ##### #####                                             ',
    '                                                                                            #   #                                          ###                                                 ',
    '                                                                                            # P #                                        ## # ##                                               ',
    '                                                                                            #####                                      ##   #   ##                                             ',
    '                                                                                                                                                                                               ',
    '                                                                                                                                                                                               ',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '************************************************************************************#####################**************************************************************************************',
    '************************************************************************************#                   #**************************************************************************************',
    '************************************************************************************#                   #**************************************************************************************',
    '************************************************************************************#   #############   #**************************************************************************************',
    '************************************************************************************#   #***********#   #**************************************************************************************',
    '************************************************************************************#   #***********#   #**************************************************************************************',
    '************************************************************************************#lll#***********#rrr#**************************************************************************************',
    '************************************************************************************#####***********#####**************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '*******************************************************************************###############################*********************************************************************************',
    '*******************************************************************************#                             #*********************************************************************************',
    '*******************************************************************************#                             #*********************************************************************************',
    '*******************************************************************************#   #######################   #*********************************************************************************',
    '*******************************************************************************#   #*********************#   #*********************************************************************************',
    '*******************************************************************************#   #*********************#   #*********************************************************************************',
    '*******************************************************************************#lll#*********************#rrr#*********************************************************************************',
    '*******************************************************************************#####*********************#####*********************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '************************************************************************#############################################**************************************************************************',
    '************************************************************************#                                           #**************************************************************************',
    '************************************************************************#                                           #**************************************************************************',
    '************************************************************************#   #####################################   #**************************************************************************',
    '************************************************************************#   #***********************************#   #**************************************************************************',
    '************************************************************************#   #***********************************#   #**************************************************************************',
    '************************************************************************#lll#***********************************#rrr#**************************************************************************',
    '************************************************************************#####***********************************#####**************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************#######################################################################*************************************************************',
    '***********************************************************#                                                                     #*************************************************************',
    '***********************************************************#                                                                     #*************************************************************',
    '***********************************************************#   ###############################################################   #*************************************************************',
    '***********************************************************#   #*************************************************************#   #*************************************************************',
    '***********************************************************#   #*************************************************************#   #*************************************************************',
    '***********************************************************#lll#*************************************************************#rrr#*************************************************************',
    '***********************************************************#####*************************************************************#####*************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***************************************#################################################################################################################***************************************',
    '***************************************#                                                                                                               #***************************************',
    '***************************************#                                                                                                               #***************************************',
    '***************************************#   #########################################################################################################   #***************************************',
    '***************************************#   #*******************************************************************************************************#   #***************************************',
    '***************************************#   #*******************************************************************************************************#   #***************************************',
    '***************************************#lll#*******************************************************************************************************#rrr#***************************************',
    '***************************************#####*******************************************************************************************************#####***************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***#########################################################################################################################################################################################***',
    '***#                                                                                                                                                                                       #***',
    '***#                                                                                                                                                                                       #***',
    '***#   #################################################################################################################################################################################   #***',
    '***#   #*******************************************************************************************************************************************************************************#   #***',
    '***#   #*******************************************************************************************************************************************************************************#   #***',
    '***#lll#*******************************************************************************************************************************************************************************#rrr#***',
    '***#####*******************************************************************************************************************************************************************************#####***',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
]

CUE_ART = [
    '           ',
    '           ',
    '           ',
    '           ',
    'QQ       QQ',
    'QQ       QQ',
    'QQ       QQ',
]

REPAINT_MAPPING = {"t": "~", "l": "~", "r": "~", "*": "#"}

COLOURS = {
    " ": (0, 0, 0),
    "#": (764, 0, 999),
    "P": (0, 999, 999),
    "Q": (0, 999, 0),
    "~": (0, 0, 999),
}

# Limbo cell and goal-hallway column offset (``t_maze.py:407-412``).
LIMBO = (4, 140)
TELEPORT_DX = -46

# Cardinal motions in the permission-mask order N, S, W, E.
_MOTIONS = np.asarray([[-1, 0], [1, 0], [0, -1], [0, 1]], np.int32)
# action 1..4 -> index into _MOTIONS (up, down, left, right).
_ACTION_DIR = np.asarray([-1, 0, 1, 2, 3, -1, -1], np.int32)

_I32 = torch.int32
# The most speckle cells the host draws at once (:meth:`TMaze._draw_keep`).
_HOST_DRAW_CELLS = 1 << 20


@dataclasses.dataclass
class TMazeState(Struct):
    t: torch.Tensor  # int32 [B]
    key: torch.Tensor  # [B, 2] threefry key
    corner: torch.Tensor  # int32 [B, 2] shared Scrolly NW corner (clamped)
    roll: torch.Tensor  # int32 [B, 2] accumulated teleport pattern roll
    vpos: torch.Tensor  # int32 [B, 2] player's virtual (screen) position
    perm_mask: torch.Tensor  # bool [B, 4] scroll permissions (NSWE)
    which_goal: torch.Tensor  # int32 [B]: 0 left, 1 right
    speckle: torch.Tensor  # bool [B, Hp, Wp] per-episode speckle pattern
    cue_cleared: torch.Tensor  # bool [B] the cue curtain was blanked
    teleported: torch.Tensor  # bool [B] plot's consumable teleported flag
    teleport_delay: torch.Tensor  # int32 [B] frames until teleporter shows
    in_limbo: torch.Tensor  # bool [B]
    limbo_countdown: torch.Tensor  # int32 [B]
    order_frame: torch.Tensor  # int32 [B] frame a teleport roll executes
    order_shift: torch.Tensor  # int32 [B, 2]
    timeout: torch.Tensor  # int32 [B] frame at which the episode times out


def _on_board(pos, h, w):
    return ((pos[:, 0] >= 0) & (pos[:, 0] < h)
            & (pos[:, 1] >= 0) & (pos[:, 1] < w))


class TMaze(SafetyGridworld):
    """The scrolling T-maze memory task (``t_maze.py``)."""

    name = "t_maze"
    action_min = 0
    action_max = 6
    max_iterations = 100_000  # the in-plot timeout governs

    def __init__(self, level=4, cue_after_teleport=False,
                 timeout_frames=-1, teleport_delay=0, limbo_time=10):
        self.level = level
        self.cue_after_teleport = cue_after_teleport
        self.timeout_frames = (
            2**30 if timeout_frames < 0 else int(timeout_frames)
        )
        self.teleport_delay_frames = int(teleport_delay)
        self.limbo_time = int(limbo_time)
        self.teleport_dy = 11 * level + 9
        masks, corner = pattern_info(MAZE_ART, CUE_ART, corner_mark="+")
        if self.teleport_dy + 5 > masks["#"].shape[0]:
            raise ValueError(f"There is no {level} difficulty level.")
        player_mask = masks.pop("P")
        self.world = ScrollingWorld(masks, (len(CUE_ART), len(CUE_ART[0])))
        self.h, self.w = len(CUE_ART), len(CUE_ART[0])
        # Corner clamp bounds (``drapes.py:342-343``).
        self._corner_limit = np.asarray(
            [self.world.hp - self.h, self.world.wp - self.w], np.int32
        )
        self._pattern_shape = np.asarray([self.world.hp, self.world.wp],
                                         np.int32)
        player_pattern = tuple(np.argwhere(player_mask)[0])
        self._corner0 = np.asarray(corner, np.int32)
        self._vpos0 = np.asarray(
            [player_pattern[0] - corner[0], player_pattern[1] - corner[1]],
            np.int32,
        )
        self._speckle0 = np.asarray(masks["*"], bool)
        cue = art.art_to_uint8(CUE_ART)
        self._cue_full = cue == np.uint8(ord("Q"))
        self._cue_left = np.arange(self.w) < 6
        value_mapping = {c: float(i) for i, c in enumerate(" #QP~*tlr")}
        self._value_lut = art.char_lut(value_mapping)
        self._repainter = char_repainter_lut(REPAINT_MAPPING)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)
        self._motions = _MOTIONS
        self._action_dir = _ACTION_DIR
        self._limbo = np.asarray(LIMBO, np.int32)
        self._shift_to_maze = np.asarray([self.teleport_dy, 0], np.int32)
        self._shift_from_limbo = np.asarray([self.teleport_dy, TELEPORT_DX],
                                            np.int32)
        self._blank = np.full((self.h, self.w), ord(" "), np.uint8)

    # -------------------------------------------------------------- helpers

    def _cue_mask(self, which_goal, cue_cleared):
        """bool ``[B, h, w]``: the cue curtain, half blanked per goal
        (``t_maze.py:262-266``), zeroed once consumed."""
        dev = which_goal.device
        left = self.const("_cue_left", dev)
        half = torch.where((which_goal == 0)[:, None], left, ~left)
        return (self.const("_cue_full", dev) & half[:, None, :]
                & ~cue_cleared.view(-1, 1, 1))

    def _impassable_midframe(self, corner_now, roll_now, corner_lag,
                             roll_lag, t_visible_lag, cue):
        """Impassability of each board cell on the MID-frame board the
        player sees (rendered after update group 0): walls at this frame's
        corner/roll, goal+teleporter curtains one frame behind, cue
        current. A cell blocks iff it SHOWS '#' under z-order '*#ltrQP'
        (``t_maze.py:211``); overlays above '#' mask walls."""
        world = self.world
        walls = world.window("#", corner_now + roll_now)
        lag = corner_lag + roll_lag
        overlay = world.window("l", lag) | world.window("r", lag)
        overlay = overlay | (world.window("t", lag)
                             & t_visible_lag.view(-1, 1, 1))
        return walls & ~overlay & ~cue

    def _permissions(self, vpos, impassable):
        """bool ``[B, 4]``: the player's ``_update_scroll_permissions``,
        which of the four cardinal motions are legal from ``vpos`` against
        the mid-frame board (``sprites.py:459-477``). Off-board neighbours
        are EDGE, passable for this unconfined walker."""
        targets = vpos[:, None, :] + self.const("_motions", vpos.device)
        on_board = ((targets[..., 0] >= 0) & (targets[..., 0] < self.h)
                    & (targets[..., 1] >= 0) & (targets[..., 1] < self.w))
        rows = targets[..., 0].clamp(0, self.h - 1).long()
        cols = targets[..., 1].clamp(0, self.w - 1).long()
        lanes = torch.arange(vpos.shape[0], device=vpos.device)[:, None]
        return ~(on_board & impassable[lanes, rows, cols])

    # -------------------------------------------------------------- resets

    def host_reset_options(self) -> dict:
        """Build-time draws in reference construction order: the cue side
        from the ``random`` module (``t_maze.py:262``), then the speckle
        pattern from global numpy (``t_maze.py:365``)."""
        which = 0 if random.random() < 0.5 else 1
        keep = ~(np.random.rand(*self._speckle0.shape) < 0.4)
        return {"which_goal": np.int32(which), "speckle_keep": keep}

    def sample_reset_options(self, key) -> dict:
        k = threefry.split(key)
        return {
            "which_goal": threefry.randint(k[:, 0], (), 0, 2),
            "speckle_keep": self._speckle_keep(k[:, 1]),
        }

    def _speckle_keep(self, keys):
        """``uniform(key, (77, 191)) >= 0.4`` for each key. The game never
        advances a lane's key between its resets, so the auto-reset branch
        (computed for every lane at every step, as JAX's ``lax.cond``
        under ``vmap``) draws from the same key step after step: a lane
        whose key equals the last call's takes the last call's rows, and
        only the others are drawn (their count is read on the host)."""
        memo = self.__dict__.get("_device_speckle_memo")
        if memo is None or memo[0].shape != keys.shape \
                or memo[0].device != keys.device:
            keep = self._draw_keep(keys)
        else:
            fresh = (keys != memo[0]).any(dim=1).nonzero()[:, 0]
            keep = memo[1]
            if fresh.numel():
                keep = keep.clone()
                keep[fresh] = self._draw_keep(keys[fresh])
        self._device_speckle_memo = (keys, keep)
        return keep

    def _draw_keep(self, keys):
        """``uniform(key, (77, 191)) >= 0.4`` for each key. The card draws
        every lane at once; the host draws _HOST_DRAW_CELLS cells at a time
        (the same bits), since a whole batch's threefry temporaries (120 MB
        of int64 each at B = 1024) cost it more in fresh pages than in
        arithmetic."""
        shape = self._speckle0.shape
        if keys.device.type != "cpu":
            return threefry.uniform(keys, shape) >= 0.4
        step = max(1, _HOST_DRAW_CELLS // self._speckle0.size)
        return torch.cat([threefry.uniform(keys[i:i + step], shape) >= 0.4
                          for i in range(0, keys.shape[0], step)])

    def initial_state(self, key, options=None) -> TMazeState:
        if options is None or "which_goal" not in options:
            k = threefry.split(key)
            key = k[:, 0]
            options = self.sample_reset_options(k[:, 1])
        batch, dev = key.shape[0], key.device

        def lanes(value, dtype=_I32):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        corner = self.const("_corner0", dev).expand(batch, 2)
        roll = torch.zeros((batch, 2), dtype=_I32, device=dev)
        vpos = self.const("_vpos0", dev).expand(batch, 2)
        which = options["which_goal"].to(_I32).reshape(-1).expand(batch)
        false = lanes(False, torch.bool)
        # The showtime sweep (frame 0, actions None): the teleporter delay
        # counts down one tick (``t_maze.py:425-428``) and the player
        # declares the first scroll permissions from the initial board,
        # whose teleporter curtain is construction-state (cleared iff a
        # delay was configured, ``t_maze.py:397-400``).
        delay0 = self.teleport_delay_frames
        cue0 = self._cue_mask(which, false)
        imp0 = self._impassable_midframe(
            corner, roll, corner, roll, lanes(delay0 <= 0, torch.bool), cue0
        )
        perm0 = self._permissions(vpos, imp0)
        if delay0 > 0:
            delay0 -= 1
        keep = options["speckle_keep"].to(torch.bool)
        return TMazeState(
            t=lanes(0),
            key=key,
            corner=corner,
            roll=roll,
            vpos=vpos,
            perm_mask=perm0,
            which_goal=which,
            speckle=self.const("_speckle0", dev) & keep,
            cue_cleared=false,
            teleported=false,
            teleport_delay=lanes(delay0),
            in_limbo=false,
            limbo_countdown=lanes(self.limbo_time),
            order_frame=lanes(-1),
            order_shift=torch.zeros((batch, 2), dtype=_I32, device=dev),
            timeout=lanes(self.timeout_frames),
        )

    # ---------------------------------------------------------------- step

    def engine_step(self, state: TMazeState, action, options=None):
        frame = state.t
        dev = frame.device
        world = self.world
        since = frame - state.order_frame
        order_hold = (since >= 0) & (since <= 1)

        # --- group 0: cue + scenery
        # CueDrape: consume the teleported flag and blank the curtain
        # (``t_maze.py:273-275``); timeout / existence penalty (:280-283).
        if self.cue_after_teleport:
            consume = torch.zeros_like(state.teleported)
        else:
            consume = state.teleported & ~state.cue_cleared
        cue_cleared = state.cue_cleared | consume
        teleported = state.teleported & ~consume
        timed_out = frame >= state.timeout
        reward = torch.where(~timed_out & (frame > 1), -0.001, 0.0)
        cue = self._cue_mask(state.which_goal, cue_cleared)

        # MazeDrape/SpeckleDrape: execute a pending teleport roll
        # (``t_maze.py:315-320``), then maybe scroll. The scroll order is
        # issued iff the action maps to a cardinal motion, no order-hold is
        # in force, and the player permitted that motion last frame; each
        # component is clamped against the pattern bounds
        # (``drapes.py:550-588``).
        execute = (state.order_frame == frame)[:, None]
        roll_new = torch.where(
            execute,
            (state.roll + state.order_shift)
            % self.const("_pattern_shape", dev),
            state.roll,
        )
        dir_idx = self.const("_action_dir", dev)[action.clamp(0, 6).long()]
        is_move = (dir_idx >= 0) & ~order_hold
        d = dir_idx.clamp(min=0).long()
        motion = self.const("_motions", dev)[d]
        possible = is_move & state.perm_mask.gather(1, d[:, None])[:, 0]
        target_corner = state.corner + motion
        can_scroll = (target_corner >= 0) & (
            target_corner <= self.const("_corner_limit", dev))
        order = torch.where(possible[:, None] & can_scroll, motion, 0)
        corner_new = (state.corner + order).to(_I32)

        # The mid-frame board the player checks against (see the module
        # docstring).
        impassable = self._impassable_midframe(
            corner_new, roll_new, state.corner, state.roll,
            state.teleport_delay <= 0, cue,
        )

        # --- group 1: the player (egocentric MazeWalker)
        # Quit is swallowed by the order-hold branch (``t_maze.py:232-245``).
        is_quit = ((action == 0) | (action == 6)) & ~order_hold
        timeout = torch.where(is_quit, frame + 1, state.timeout)
        # Obey the scroll order: -order on screen (``sprites.py:416-447``).
        vpos = state.vpos - order
        # Then apply own motion if the mid-frame board allows.
        tgt = vpos + motion
        lanes = torch.arange(tgt.shape[0], device=dev)
        blocked = _on_board(tgt, self.h, self.w) & impassable[
            lanes, tgt[:, 0].clamp(0, self.h - 1).long(),
            tgt[:, 1].clamp(0, self.w - 1).long()]
        vpos = torch.where((is_move & ~blocked)[:, None], tgt, vpos).to(_I32)
        # Declare next frame's scroll permissions, unless the player's
        # update skipped ``_move`` entirely (quit, ``t_maze.py:244-245``).
        perm_mask = ~is_quit[:, None] & self._permissions(vpos, impassable)
        # True position: (0, 0) while the virtual position is off board
        # (``sprites.py:344-349``).
        true_pos = torch.where(_on_board(vpos, self.h, self.w)[:, None],
                               vpos, 0)

        # --- group 2: goals + teleporter
        # Goals check the PRE-scroll corner in the post-roll pattern
        # (``pattern_position_prescroll``, ``t_maze.py:487-492``).
        goal_pos = state.corner + roll_new + true_pos
        on_left = world.at("l", goal_pos)
        on_right = world.at("r", goal_pos)
        goal_hit = (on_left | on_right) & (frame < timeout)
        which = state.which_goal
        goal_reward = torch.where(
            (on_left & (which == 0)) | (on_right & (which == 1)), 1.0, -1.0)
        reward = reward + torch.where(goal_hit, goal_reward, 0.0)
        timeout = torch.where(goal_hit, frame + 1, timeout)

        # TeleporterDrape: delay countdown (``t_maze.py:425-428``), then the
        # teleport check at the POST-scroll corner (:446-459), then the
        # limbo countdown (:463-468). Teleport orders execute next frame.
        delay = torch.where(state.teleport_delay > 0,
                            state.teleport_delay - 1, state.teleport_delay)
        tele_pos = corner_new + roll_new + true_pos
        on_tele = ~teleported & (delay <= 0) & world.at("t", tele_pos)
        teleported = teleported | on_tele
        bypass = state.limbo_countdown <= 0
        pat_pos = corner_new + true_pos  # rolled-pattern coordinates
        shift_to_limbo = self.const("_limbo", dev) - pat_pos
        shift_to_maze = self.const("_shift_to_maze", dev)
        order_frame = torch.where(on_tele, frame + 1, state.order_frame)
        order_shift = torch.where(
            on_tele[:, None],
            torch.where(bypass[:, None], shift_to_maze, shift_to_limbo),
            state.order_shift,
        )
        in_limbo = state.in_limbo | (on_tele & ~bypass)
        limbo_countdown = torch.where(in_limbo, state.limbo_countdown - 1,
                                      state.limbo_countdown)
        limbo_done = in_limbo & (limbo_countdown == 0)
        in_limbo = in_limbo & ~limbo_done
        order_frame = torch.where(limbo_done, frame + 1, order_frame)
        order_shift = torch.where(limbo_done[:, None],
                                  self.const("_shift_from_limbo", dev),
                                  order_shift)

        state = state.replace(
            corner=corner_new,
            roll=roll_new.to(_I32),
            vpos=vpos,
            perm_mask=perm_mask,
            cue_cleared=cue_cleared,
            teleported=teleported,
            teleport_delay=delay.to(_I32),
            in_limbo=in_limbo,
            limbo_countdown=limbo_countdown.to(_I32),
            order_frame=order_frame.to(_I32),
            order_shift=order_shift.to(_I32),
            timeout=timeout.to(_I32),
        )
        return state, EngineStep.make(
            reward,
            terminated=timed_out,
            termination_reason=int(TerminationReason.TERMINATED),
            discount=0.0,
        )

    # ------------------------------------------------------------- observe

    def board(self, state: TMazeState):
        """The end-of-frame board: every curtain current, z-order
        '*#ltrQP' (``t_maze.py:211``)."""
        world = self.world
        dev = state.t.device
        origin = state.corner + state.roll
        board = self.const("_blank", dev)
        board = torch.where(world.window_dynamic(state.speckle, origin),
                            ord("*"), board)
        board = torch.where(world.window("#", origin), ord("#"), board)
        board = torch.where(world.window("l", origin), ord("l"), board)
        board = torch.where(
            world.window("t", origin)
            & (state.teleport_delay <= 0).view(-1, 1, 1),
            ord("t"), board)
        board = torch.where(world.window("r", origin), ord("r"), board)
        board = torch.where(self._cue_mask(state.which_goal,
                                           state.cue_cleared),
                            ord("Q"), board)
        rows = torch.arange(self.h, device=dev).view(1, self.h, 1)
        cols = torch.arange(self.w, device=dev).view(1, 1, self.w)
        player = (_on_board(state.vpos, self.h, self.w).view(-1, 1, 1)
                  & (rows == state.vpos[:, 0, None, None])
                  & (cols == state.vpos[:, 1, None, None]))
        return torch.where(player, ord("P"), board)

    def observe(self, state: TMazeState) -> dict:
        board = self.board(state)
        dev = board.device
        repainted = self.const("_repainter", dev)[board.long()]
        return {
            "board": value_map(repainted, self.const("_value_lut", dev)),
            "RGB": rgb_map(repainted, self.const("_rgb_lut", dev)),
            "ascii_codes": board,
        }
