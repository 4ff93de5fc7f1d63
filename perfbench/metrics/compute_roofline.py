"""The benchmark's work bytes of the traced slice over what the card's
memory could move in the seconds a kernel ran (copies and fills left
out): a request's work counts by the share of its service interval
(``RequestRecord`` t_start to t_finish) inside the slice.  The numerator
comes from shapes, so any implementation of the workloads reads on the
same work."""


def read(r):
    dt = r.window.device_trace
    peak = r.peak("hbm_bytes_per_s")
    if dt is None or peak is None:
        return None
    kernel_s = dt.kernel_s()
    if kernel_s <= 0:
        return None
    work = 0.0
    for a in r.window.answers:
        if not a.ok or a.t_start is None or a.t_finish <= a.t_start:
            continue
        inside = min(a.t_finish, dt.hi) - max(a.t_start, dt.lo)
        if inside > 0:
            work += a.work * inside / (a.t_finish - a.t_start)
    return 100.0 * work / (kernel_s * peak) if work else None
