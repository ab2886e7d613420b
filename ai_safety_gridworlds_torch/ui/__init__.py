"""Human-playable curses UI (see :mod:`.safety_ui`)."""

from ai_safety_gridworlds_torch.ui.safety_ui import (  # noqa: F401
    SafetyCursesUi,
    SafetyCursesUiEx,
    make_human_curses_ui,
    make_human_curses_ui_with_noop_keys,
    render_frame,
)
