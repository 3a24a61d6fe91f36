"""The share of the scored rows that are padding: the `padded_rows` over
the `rows` counted on the scorer's `salve/batch` spans, in %. Each floor's
last batch is filled up with its last hypothesis to the batch size."""

from benchmark.metrics._spans import named, record


def read(ctx):
    spans = record(ctx, "fused_scoring")
    if spans is None:
        return None
    batches = named(spans, "salve/batch")
    rows = sum(s["counts"].get("rows", 0) for s in batches)
    if rows <= 0:
        return None
    return 100.0 * sum(s["counts"].get("padded_rows", 0) for s in batches) / rows
