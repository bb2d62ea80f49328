"""Host time, in ms, from a request's post of a PBS batch to the start of
the dispatch that carries it, mean over the window's posts (the program's
``pbs_wait_ns`` over its ``pbs_posts``).  Nothing to read from a program
without the counters."""


def read(window):
    wait = getattr(window.totals, "pbs_wait_ns", None)
    posts = getattr(window.totals, "pbs_posts", None)
    if wait is None or not posts:
        return None
    return wait / posts / 1e6
