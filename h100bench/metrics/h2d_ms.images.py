"""Mean batch_to_device span (the copy synchronized inside it) a batch."""
from benchlib import readers


def read(run):
    if not readers.images(run):
        return None
    return readers.mean_ms(readers.window_spans_s(run, "batch_to_device"))
