"""Median of the program's queue wait (``RequestRecord.queue_wait``:
submit to the start of service) over the window's requests."""
import numpy as np


def read(r):
    waits = [a.queue_wait for a in r.window.answers
             if a.ok and a.queue_wait is not None]
    return float(np.percentile(waits, 50)) * 1e3 if waits else None
