"""matplotlib for the port's figures, and what a figure does without it.

Every figure of the port imports matplotlib through this module, inside the
function that draws, so every module and CLI starts where matplotlib is not
installed (the card's machine has none). The functions that draw call
`matplotlib.use("Agg")` where salve_tpu's do, and draw what salve_tpu's
draw. Where matplotlib is absent, two rules:

(a) A figure that is the product -- a plotting CLI, or a drawing function
    called directly -- raises `MatplotlibMissing`, naming the figure,
    before it writes anything (`require`, `pyplot`, `figure_class`,
    `patches`).
(b) A figure drawn beside a computation -- the floor report's side-by-side
    floorplans and IoU masks, the stitched `final.png` -- is left out
    (`draw_side_figure` returns False). The computation writes everything
    else, unchanged, and one warning a process names the figures left out.
"""

from __future__ import annotations

import importlib.util
import logging

logger = logging.getLogger(__name__)

# The side figures named in a warning of this process (rule (b)).
_warned = set()


class MatplotlibMissing(ImportError):
    """A figure was asked for where matplotlib is not installed."""


def installed() -> bool:
    """Whether matplotlib can be imported here."""
    return importlib.util.find_spec("matplotlib") is not None


def require(what: str) -> None:
    """Rule (a): raise `MatplotlibMissing` naming `what` unless matplotlib is installed."""
    if not installed():
        raise MatplotlibMissing(f"{what} needs matplotlib, which is not installed")


def _matplotlib(what: str, agg: bool):
    require(what)
    import matplotlib

    if agg:
        matplotlib.use("Agg")
    return matplotlib


def pyplot(what: str = "this figure", agg: bool = True):
    """`matplotlib.pyplot`, on the Agg backend unless `agg` is False (a
    function that draws into the caller's current figure, or opens a window,
    keeps the caller's backend, as salve_tpu's does)."""
    _matplotlib(what, agg)
    import matplotlib.pyplot as plt

    return plt


def figure_class(what: str = "this figure"):
    """`matplotlib.figure.Figure`, on the Agg backend."""
    _matplotlib(what, True)
    from matplotlib.figure import Figure

    return Figure


def patches(what: str = "this figure"):
    """(`matplotlib.patches`, `matplotlib.path.Path`), keeping the backend."""
    _matplotlib(what, False)
    import matplotlib.patches as mpatches
    from matplotlib.path import Path

    return mpatches, Path


def draw_side_figure(what: str) -> bool:
    """Rule (b): whether to draw the side figure `what`. Without matplotlib
    it returns False and, the first time this process asks for `what`, logs
    a warning naming it."""
    if installed():
        return True
    if what not in _warned:
        _warned.add(what)
        logger.warning("matplotlib is not installed: %s left out; every other output is written as with it", what)
    return False
