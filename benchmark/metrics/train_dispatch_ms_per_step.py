"""Host time in the train step's `salve/step` spans over the steps, in ms:
the host's dispatch of one step (augmentation, forward and loss, backward,
Adam), to hold against the card's time a step."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "verifier_training"), "salve/step", "salve/step")
