"""Host time in the scorer's `salve/layout` spans (moving and padding the
layouts, their upload and the raster's dispatch; pano 2's bank a floor and
pano 1's rows a batch) over its `salve/batch` spans, in ms (program span).
None where no batch has a `layout` span (a program without the layout
stage, or an RGB verifier)."""

from benchmark.metrics._spans import ms_per, named, record


def read(ctx):
    spans = record(ctx, "layout_scoring")
    if spans is None or not named(spans, "salve/layout"):
        return None
    return ms_per(spans, "salve/layout", "salve/batch")
