"""Tokens trained in the window, over its seconds."""
from benchlib import readers


def read(run):
    if readers.images(run) or run.window_s <= 0:
        return None
    return run.steps * run.tokens_per_step / run.window_s
