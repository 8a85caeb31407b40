"""Mean wait of the trainer for a batch: the gap between consecutive
run_training_batch spans in the window."""
from benchlib import readers


def read(run):
    return readers.mean_ms(readers.step_gaps_s(run)) if readers.images(run) else None
