"""Host time in the train step's `salve/optimizer` spans (`OptaxAdam.step`:
the decayed Adam update of every leaf) over the steps, in ms."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "verifier_training"), "salve/optimizer", "salve/step")
