"""Model FLOPs of the window's steps over their summed step spans times the TF32 dense peak."""
from benchlib import readers


def read(run):
    return readers.step_mfu_pct(run) if readers.images(run) else None
