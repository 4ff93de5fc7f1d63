"""Median of submit -> result over every request sent in the window.  In a
closed loop every client always has one request in the system, so this is
about clients over the rate the host paces, and it is read beside
``work_GBps``, not bounded as an end-to-end metric."""
import numpy as np


def read(r):
    lat = r.latencies_s()
    return float(np.percentile(lat, 50)) * 1e3 if len(lat) else None
