"""The host's time to enqueue a step: the mean self time of the window's
run_training_batch spans less their step_sync child (the .item())."""
from benchlib import phases


def read(run):
    return phases.dispatch_ms(run)
