"""Share of the window's requests that the program served from its
resident-operand cache (``RequestRecord.cache_hit``)."""


def read(r):
    hits = [a.cache_hit for a in r.window.answers
            if a.ok and a.cache_hit is not None]
    return 100.0 * sum(hits) / len(hits) if hits else None
