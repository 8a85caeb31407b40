"""Mean wait of the trainer on the device prefetch ring's queue: its
ring_wait spans in the window."""
from benchlib import phases


def read(run):
    return phases.ring_wait_ms(run)
