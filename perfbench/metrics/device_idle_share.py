"""Share of the traced slice in which no kernel, copy or fill ran on the
card."""


def read(r):
    dt = r.window.device_trace
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
