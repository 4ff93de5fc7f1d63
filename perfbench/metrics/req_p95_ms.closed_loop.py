"""95th percentile of submit -> result over every request sent in the
window (see ``req_p50_ms.closed_loop``)."""
import numpy as np


def read(r):
    lat = r.latencies_s()
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
