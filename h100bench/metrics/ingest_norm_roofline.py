"""The ingest_norm kernel's bound (its least bytes at the card's HBM rate) over
its mean device time in the traced window."""
import statistics

from benchlib import arith, readers

KERNEL = "ingest_norm_kernel"


def read(run):
    if run.trace is None or not readers.images(run):
        return None
    times = run.trace.durations(KERNEL)
    if not times:
        return None
    side = run.cfg["image_size"]
    nbytes = arith.ingest_norm_bytes(run.items_per_step, side, side)
    return arith.roofline_pct(0.0, nbytes, statistics.fmean(times), 1.0)
