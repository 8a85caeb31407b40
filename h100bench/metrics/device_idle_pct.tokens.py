"""The share of the traced window in which no kernel, copy or memset ran."""
from benchlib import readers


def read(run):
    return None if readers.images(run) else readers.device_idle_pct(run)
