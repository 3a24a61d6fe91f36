"""Share of the traced layout floors' untraced time in which the trace shows
no kernel, copy or fill on the card (a lower bound: _common.idle_pct)."""

from benchmark.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx, "layout_scoring")
