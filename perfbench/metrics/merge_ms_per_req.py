"""Host merge time a request: the program's ``merge`` spans (its tracer,
``runtime/trace.py``; one a request) that ended in the window, over their
number.  A traced run keeps the spans of its profiled slice."""


def read(r):
    w = r.window
    merges = [s.t1 - s.t0 for s in w.spans
              if s.name == "merge" and w.t0 <= s.t1 <= w.t_end]
    return sum(merges) / len(merges) * 1e3 if merges else None
