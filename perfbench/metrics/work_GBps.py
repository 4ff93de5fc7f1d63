"""All work completed in the window over the window's seconds: for each
request answered by the close, the bytes its computation needs (inputs
read once, outputs written once, from the shapes the benchmark made)."""


def read(r):
    w = r.window
    done = sum(a.work for a in w.answers if a.ok and a.t_done <= w.t_end)
    return done / (w.t_end - w.t0) / 1e9
