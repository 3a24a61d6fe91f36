"""The share of the scorer's floors whose banks were built as a replayed
CUDA graph: the `banks/graph_replays` counted on the `salve/banks` spans
over the number of those spans, in % (a floor that captured its graph
replays it too, so the share cannot tell a capture from a replay; the
program keeps each graph for the process, so a pano count captures once).
Floors of more panos than the program graphs build their banks eagerly
and lower the share. Read in either scoring cell. None where no span carries
one of the banks' counters (a program older than the graph) and on the
CPU, which builds the banks eagerly by design."""

from benchmark.metrics._spans import named, record

COUNTERS = ("banks/graph_replays", "banks/graph_captures", "banks/eager")


def read(ctx):
    spans = record(ctx, "fused_scoring") or record(ctx, "fresh_scoring")
    if spans is None or ctx.get("kind") == "cpu":
        return None
    banks = named(spans, "salve/banks")
    if not any(c in s["counts"] for s in banks for c in COUNTERS):
        return None
    return 100.0 * sum(s["counts"].get("banks/graph_replays", 0) for s in banks) / len(banks)
