"""Model FLOPs of the window's steps over their summed step spans times the bf16 dense peak."""
from benchlib import readers


def read(run):
    return None if readers.images(run) else readers.step_mfu_pct(run)
