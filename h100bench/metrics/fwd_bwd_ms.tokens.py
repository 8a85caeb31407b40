"""Device milliseconds a step in the forward, backward and gradient sum of
its microbatches: the step_fwd_bwd spans, mean over the window's steps."""
from benchlib import phases


def read(run):
    return phases.phase_ms(run, phases.FWD_BWD)
