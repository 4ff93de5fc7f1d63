"""Host-to-device copies in the traced slice: their bytes over the seconds
in which one ran (copies on several streams at once count once)."""
from harness.devtrace import length


def read(r):
    dt = r.window.device_trace
    if dt is None:
        return None
    copies = dt.copies("HtoD")
    busy = length((o.t0, o.t1) for o in copies)
    if not copies or busy <= 0:
        return None
    return sum(o.nbytes for o in copies) / busy / 1e9
