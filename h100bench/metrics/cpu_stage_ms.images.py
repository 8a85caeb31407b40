"""Mean CPU-stage time a sample: stage_decode plus stage_augment spans in the
window, over the samples decoded."""
from benchlib import readers


def read(run):
    return readers.cpu_stage_ms(run)
