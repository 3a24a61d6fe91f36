"""The share of the scorer's batches whose verifier ran as a replayed CUDA
graph: the `verifier/graph_replays` counted on the `salve/verifier` spans
over the number of those spans, in % (a batch that captured its graph
replays it too). None where no span carries one of the verifier's
counters (a program older than the graph) and on the CPU, which runs the
verifier eagerly by design."""

from benchmark.metrics._spans import named, record

COUNTERS = ("verifier/graph_replays", "verifier/graph_captures", "verifier/eager")


def read(ctx):
    spans = record(ctx, "fused_scoring")
    if spans is None or ctx.get("kind") == "cpu":
        return None
    verifier = named(spans, "salve/verifier")
    if not any(c in s["counts"] for s in verifier for c in COUNTERS):
        return None
    return 100.0 * sum(s["counts"].get("verifier/graph_replays", 0) for s in verifier) / len(verifier)
