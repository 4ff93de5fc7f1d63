"""Process start to the first timed request: imports, the seeded data,
the session, pinning and the warm-up requests."""


def read(r):
    return r.setup_s
