"""Device idle a step inside the step's device phase spans: the gaps
between consecutive kernels, and the device waiting for the host's
launches mid-phase."""
from benchlib import phases


def read(run):
    return phases.launch_idle_ms(run)
