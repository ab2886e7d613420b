"""The Ordeal: a three-chapter Story demo (slay the dragon/duck!).

Port of ``ai_safety_gridworlds_tpu/envs/ordeal.py`` (pycolab's
``examples/ordeal.py``, the canonical ``storytelling.Story`` demonstration):
three sub-games (Kansas, the castle, the cavern) chained behind one
interface. Walking off designated map edges moves between chapters with
position carry-over; the cavern's sword (+1) persists in the shared plot;
the castle's dragonduck chases the player diagonally, and contact ends the
story (+1 with the sword, -1 without, ``ordeal.py:141-186``).

The chapters are functional games on a batch of lanes like every game of
the port; the Story steps each through the port's ``SafetyEnvironment``
(one lane on ``device``), whose shell writes the plot from lane 0 on the
host (``helpers.safety_env.fetch_lane``, one copy a step).

Actions: 0=up 1=down 2=left 3=right 4=quit.
Use :func:`make_ordeal_story`; the Kansas chapter pairs with a
``ScrollingCropper(8, 15, scroll_margins=(2, 3))`` for display, exactly as
upstream.
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
from ai_safety_gridworlds_torch.core.cropping import ScrollingCropper
from ai_safety_gridworlds_torch.core.render import (
    paint_sprite,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_torch.core.storytelling import Story
from ai_safety_gridworlds_torch.core.timestep import TerminationReason
from ai_safety_gridworlds_torch.helpers.safety_env import (
    SafetyEnvironment,
    fetch_lane,
)

GAME_ART_CASTLE = [
    "##  ##   ##  ##",
    "###############",
    "#             #",
    "#      D      #",
    "#             #",
    "#             #",
    "#             #",
    "###### P ######",
]

GAME_ART_CAVERN = [
    "@@@@@@@@@@@@@@@",
    "@@@@@@     @@@@",
    "@@@@@      @@@@",
    "@ @@    S    @@",
    "            @@@",
    "P @@@     @@@@@",
    "@@@@@@  @@@@@@@",
    "@@@@@@@@@@@@@@@",
]

GAME_ART_KANSAS = [
    "######%%%######wwwwwwwwwwwwwwwwwwwwww@wwwwwww",
    "w~~~~~%%%~~~~~~~~~~~~~~~~@~~~wwwww~~~~~~~~~~@",
    "ww~~~~%%%~~~~~~~~~@~~~~~~~~~~~~~~~~~~~~~~@@@@",
    "ww~~~~~%%%%~~~~~~~~~~~~~~~~~~~~~~~~~~~~~@@@@@",
    "@ww~~~~~~%%%%~~~~~~~~~~~~~@~~%%%%%%%%%%%%%%%%",
    "ww~~~~~~~~~~%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%",
    "w~~~~~~@~~~~~~~~%%%%%%%%%%%%%%~~~~~~~~~~~~@@@",
    "ww~~~~~~~~~~P~~~~~~~~~~~~~~~~~~~~~~~~~@~~~@@@",
    "wwww~@www~~~~~~~~~wwwwww~~~@~~~~wwwww~~~~~~ww",
    "wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwww",
]

IMPASSABLE = "@#w"
_DELTAS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)], np.int32)

COLOURS = {
    "#": (599, 599, 599),
    "@": (465, 265, 0),
    "w": (0, 350, 780),
    "~": (280, 680, 200),
    "%": (660, 570, 200),
    " ": (858, 858, 858),
    "P": (0, 706, 999),
    "D": (999, 200, 200),
    "S": (999, 862, 110),
}

_I32 = torch.int32


@dataclasses.dataclass
class OrdealState(Struct):
    t: torch.Tensor  # int32 [B]
    key: torch.Tensor  # [B, 2] threefry key (the chapters draw nothing)
    pos: torch.Tensor  # int32 [B, 2] player
    dragon: torch.Tensor  # int32 [B, 2] (castle only; (-1, -1) elsewhere)
    has_sword: torch.Tensor  # bool [B]
    sword_present: torch.Tensor  # bool [B] (cavern only)
    exit_code: torch.Tensor  # int32 [B] 0=none 1=north 2=south 3=west 4=east


def _step_out(state, action, reward, terminated):
    """The chapters' EngineStep: TERMINATED when the chapter ends."""
    return state, EngineStep.make(
        reward,
        terminated=terminated,
        termination_reason=torch.where(
            terminated, int(TerminationReason.TERMINATED),
            int(TerminationReason.NONE),
        ),
        discount=0.0,
        actual_action=action,
    )


class _OrdealChapter(SafetyGridworld):
    """Shared chapter machinery: player motion, edge exits, quit."""

    art_rows: list = []
    what_lies_beneath = " "
    action_min = 0
    action_max = 4
    max_iterations = 10_000
    # Which edge exits are open, as action -> (predicate, exit code).
    edge_exits: dict = {}

    def __init__(self, plot=None):
        self.plot = plot if plot is not None else {}
        board0 = art.art_to_uint8(self.art_rows)
        self.h, self.w = board0.shape
        self._player0 = art.position_of(board0, "P")
        self._blocked = np.zeros_like(board0, bool)
        for c in IMPASSABLE:
            self._blocked |= art.char_mask(board0, c)
        self._backdrop = art.replace_chars(
            board0, "PDS", self.what_lies_beneath
        )
        value_mapping = {c: float(i) for i, c in enumerate(" ~%#@w")}
        value_mapping.update({"P": 6.0, "D": 7.0, "S": 8.0})
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)
        self._deltas = _DELTAS
        self._dragon0 = np.array([-1, -1], np.int32)

    def _start_pos(self):
        """Chapter entry position: line up with where the player left the
        previous chapter (``ordeal.py:248-264``)."""
        prior = self.plot.get("prior_chapter")
        last = self.plot.get("last_position")
        if prior is None or last is None:
            return self._player0
        return self._carry_position(prior, last)

    def _carry_position(self, prior, last):
        return self._player0

    def _blocked_at(self, r, c):
        blocked = self.const("_blocked", r.device)
        return blocked[r.clamp(0, self.h - 1).long(),
                       c.clamp(0, self.w - 1).long()]

    def _move_player(self, state, action):
        delta = self.const("_deltas", action.device)[
            action.clamp(0, 4).long()]
        target = state.pos + delta
        inb = ((target[:, 0] >= 0) & (target[:, 0] < self.h)
               & (target[:, 1] >= 0) & (target[:, 1] < self.w))
        blocked = ~inb | self._blocked_at(target[:, 0], target[:, 1])
        return torch.where(((action < 4) & ~blocked)[:, None], target,
                           state.pos)

    def _edge_exit(self, state, action):
        """Exit code if this action walks off an open edge
        (``ordeal.py:212-239``)."""
        code = torch.zeros_like(action)
        for act, (pred, exit_code) in self.edge_exits.items():
            code = torch.where((action == act) & pred(state), exit_code,
                               code)
        return code.to(_I32)

    def _moved(self, state, action):
        """The edge exit and the player's position after this action."""
        exit_code = self._edge_exit(state, action)
        pos = torch.where((exit_code > 0)[:, None], state.pos,
                          self._move_player(state, action)).to(_I32)
        return exit_code, pos

    def initial_state(self, key, options=None) -> OrdealState:
        batch, dev = key.shape[0], key.device
        pos = np.asarray(self._start_pos(), np.int32)
        has_sword = bool(self.plot.get("has_sword", False))

        def lanes(value, dtype):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        return OrdealState(
            t=lanes(0, _I32),
            key=key,
            pos=torch.as_tensor(pos, device=dev).expand(batch, 2),
            dragon=self.const("_dragon0", dev).expand(batch, 2),
            has_sword=lanes(has_sword, torch.bool),
            sword_present=lanes(not has_sword, torch.bool),
            exit_code=lanes(0, _I32),
        )

    def observe(self, state) -> dict:
        board = self.board(state)
        dev = board.device
        return {
            "board": value_map(board, self.const("_value_lut", dev)),
            "RGB": rgb_map(board, self.const("_rgb_lut", dev)),
            "ascii_codes": board,
        }

    def board(self, state):
        board = self.const("_backdrop", state.pos.device)
        return paint_sprite(board, state.pos, ord("P"))


class KansasChapter(_OrdealChapter):
    """The overworld: north edge -> castle, east edge -> cavern."""

    name = "ordeal_kansas"
    art_rows = GAME_ART_KANSAS
    what_lies_beneath = "~"

    def __init__(self, plot=None):
        super().__init__(plot)
        self.edge_exits = {
            0: (lambda s: s.pos[:, 0] <= 0, 1),  # north -> castle
            3: (lambda s: s.pos[:, 1] >= self.w - 1, 4),  # east -> cavern
        }

    def _carry_position(self, prior, last):
        if prior == "castle":
            return np.array([0, last[1]], np.int32)
        if prior == "cavern":
            return np.array([last[0], self.w - 1], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        exit_code, pos = self._moved(state, action)
        terminated = (action == 4) | (exit_code > 0)
        state = state.replace(pos=pos, exit_code=exit_code)
        return _step_out(state, action, torch.zeros_like(pos[:, 0],
                                                         dtype=torch.float32),
                         terminated)


class CastleChapter(_OrdealChapter):
    """The castle: a diagonal-chasing dragonduck; south edge -> kansas."""

    name = "ordeal_castle"
    art_rows = GAME_ART_CASTLE

    def __init__(self, plot=None):
        super().__init__(plot)
        board0 = art.art_to_uint8(self.art_rows)
        self._dragon0 = art.position_of(board0, "D")
        self.edge_exits = {
            1: (lambda s: s.pos[:, 0] >= self.h - 1, 2),  # south -> kansas
        }

    def _carry_position(self, prior, last):
        if prior == "kansas":
            return np.array([self.h - 1, last[1]], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        exit_code, pos = self._moved(state, action)

        # The dragonduck shuffles toward the player, diagonals allowed,
        # walls impassable (``ordeal.py:141-167``); it rests on frame 0.
        d = state.dragon
        target = d + torch.sign(pos - d)
        tr = target[:, 0].clamp(0, self.h - 1)
        tc = target[:, 1].clamp(0, self.w - 1)
        ok = ~self._blocked_at(tr, tc)
        dragon = torch.where(ok[:, None], torch.stack([tr, tc], dim=1),
                             d).to(_I32)

        # Battle check against the LAST-RENDERED player layer (the
        # reference reads ``layers['P']``, the player's PRE-move cell, so
        # that swap-throughs still battle, ``ordeal.py:170-176``).
        battle = (dragon == state.pos).all(dim=1)
        reward = torch.where(battle,
                             torch.where(state.has_sword, 1.0, -1.0), 0.0)
        # A battle ends the whole story (next_chapter None); an edge exit
        # ends only the chapter.
        exit_code = torch.where(battle, -1, exit_code).to(_I32)
        terminated = (action == 4) | battle | (exit_code > 0)
        state = state.replace(pos=pos, dragon=dragon, exit_code=exit_code)
        return _step_out(state, action, reward, terminated)

    def board(self, state):
        board = self.const("_backdrop", state.pos.device)
        # The terminal battle's z-order (``ordeal.py:180-185``, the
        # engine's post-directive re-render, ``engine.py:628-637``): with
        # the sword the dragonduck is moved in front of the player;
        # without, the player is in front (the default).
        d_on_top = ((state.exit_code == -1) & state.has_sword).view(-1, 1, 1)
        p_top = paint_sprite(
            paint_sprite(board, state.dragon, ord("D")),
            state.pos, ord("P"),
        )
        d_top = paint_sprite(
            paint_sprite(board, state.pos, ord("P")),
            state.dragon, ord("D"),
        )
        return torch.where(d_on_top, d_top, p_top)


class CavernChapter(_OrdealChapter):
    """The cavern: collect the sword (+1); west edge -> kansas."""

    name = "ordeal_cavern"
    art_rows = GAME_ART_CAVERN

    def __init__(self, plot=None):
        super().__init__(plot)
        board0 = art.art_to_uint8(self.art_rows)
        self._sword_pos = art.position_of(board0, "S")
        self.edge_exits = {
            2: (lambda s: s.pos[:, 1] <= 0, 3),  # west -> kansas
        }

    def _carry_position(self, prior, last):
        if prior == "kansas":
            return np.array([last[0], 0], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        exit_code, pos = self._moved(state, action)
        sword = self.const("_sword_pos", pos.device)
        on_sword = state.sword_present & (pos == sword).all(dim=1)
        reward = torch.where(on_sword, 1.0, 0.0)
        state = state.replace(
            pos=pos,
            has_sword=state.has_sword | on_sword,
            sword_present=state.sword_present & ~on_sword,
            exit_code=exit_code,
        )
        terminated = (action == 4) | (exit_code > 0)
        return _step_out(state, action, reward, terminated)

    def board(self, state):
        dev = state.pos.device
        board = self.const("_backdrop", dev)
        board = paint_sprite(
            board,
            self.const("_sword_pos", dev).expand(state.pos.shape[0], 2),
            ord("S"), visible=state.sword_present,
        )
        return paint_sprite(board, state.pos, ord("P"))


class _ChapterShell(SafetyEnvironment):
    """Stateful shell that writes chapter-transition facts into the shared
    plot when its episode ends (the functional analogue of the reference
    sprites writing ``the_plot.next_chapter`` / ``last_position``), from
    the lane read back to the host once a step."""

    _EXIT_TO_CHAPTER = {1: "castle", 2: "kansas", 3: "kansas", 4: "cavern"}

    def __init__(self, game, chapter_name, plot, device="cuda"):
        self._chapter_name = chapter_name
        self._plot = plot
        super().__init__(game, device=device)

    def step(self, action):
        timestep = super().step(action)
        state = self._state
        lane = fetch_lane({"has_sword": state.has_sword, "pos": state.pos,
                           "exit_code": state.exit_code})
        self._plot["has_sword"] = bool(lane["has_sword"])
        self._plot["last_position"] = tuple(int(x) for x in lane["pos"])
        if timestep.step_type.last():
            code = int(lane["exit_code"])
            self._plot["prior_chapter"] = self._chapter_name
            if code in self._EXIT_TO_CHAPTER:
                self._plot["next_chapter"] = self._EXIT_TO_CHAPTER[code]
            else:
                self._plot["next_chapter"] = None  # battle or quit: the end
        return timestep


def player_position(env) -> np.ndarray:
    """The player's (row, col) in a chapter shell's lane, on the host."""
    return fetch_lane({"pos": env._state.pos})["pos"]


def make_ordeal_story(device="cuda") -> Story:
    """Assemble the three chapters behind one Story (``ordeal.py:80-108``),
    each chapter's shell on ``device``."""

    def castle(plot):
        return _ChapterShell(CastleChapter(plot), "castle", plot, device)

    def cavern(plot):
        return _ChapterShell(CavernChapter(plot), "cavern", plot, device)

    def kansas(plot):
        return _ChapterShell(KansasChapter(plot), "kansas", plot, device)

    return Story(
        {"castle": castle, "cavern": cavern, "kansas": kansas},
        first_chapter="kansas",
        # Per-chapter croppers as the reference's (``ordeal.py:104-110``):
        # only Kansas is windowed, tracking the player with margins (2, 3)
        # and no padding (the window clamps to the board).
        croppers={"kansas": (kansas_cropper(), player_position)},
    )


def kansas_cropper() -> ScrollingCropper:
    """The upstream display cropper for the Kansas overworld
    (``ordeal.py:104-105``: rows=8, cols=15, margins (2, 3), no pad)."""
    return ScrollingCropper(8, 15, scroll_margins=(2, 3))
