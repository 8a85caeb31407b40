"""Device milliseconds a step in the optimizer phase (norms, clip, AdamW):
the step_optimizer spans, mean over the window's steps."""
from benchlib import phases


def read(run):
    return phases.phase_ms(run, phases.OPTIMIZER)
