"""95th percentile of the trainer's wait for a batch over every step of the
window."""
from benchlib import readers


def read(run):
    return readers.p95_ms(readers.step_gaps_s(run)) if readers.images(run) else None
