"""Images whose train step completed in the window, over its seconds."""
from benchlib import readers


def read(run):
    return readers.items_per_s(run)
