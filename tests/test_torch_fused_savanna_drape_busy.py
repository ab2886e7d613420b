"""K8/K9's grouped drape cutoff against the plain drape on a busy state of FULL
with sustainability: case (a) of tests/test_torch_fused_savanna_groups.py,
one configuration a file so that pytest-xdist's --dist loadfile runs the
three on separate workers."""

import pytest

from test_torch_fused_savanna_groups import GROUPS, check_grouped_cutoff
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_drape_cutoff_equals_the_plain_drape(g, monkeypatch):
    check_grouped_cutoff("busy", g, monkeypatch)
