"""Pieces of the fused island_navigation_ex_ma kernel shared with others.

Port of ``_table_sel`` from ``ai_safety_gridworlds_tpu/ops/fused_island_ma.py``;
the island kernel itself is a later slice (``ROADMAP.md``).
"""

from __future__ import annotations

import torch


def _table_sel(table_2d, action_ids: torch.Tensor, dir_ids: torch.Tensor):
    """``table[action, dir]`` for a tiny static ``[n_actions, 4]`` table.

    Action ids outside ``1..n_actions-1`` read row 0 and directions outside
    ``0..3`` give 0, as the reference's select chain does."""
    out = torch.zeros_like(dir_ids)
    for d in range(4):
        row = torch.full_like(action_ids, int(table_2d[0, d]))
        for a in range(1, table_2d.shape[0]):
            row = torch.where(action_ids == a, int(table_2d[a, d]), row)
        out = torch.where(dir_ids == d, row, out)
    return out
