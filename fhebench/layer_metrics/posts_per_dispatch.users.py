"""Requests' PBS batches merged into one dispatch, mean over the window:
the program's ``pbs_posts`` (batches the requests posted to the shortint
layer's coalescer) over its ``pbs_calls`` (batches dispatched), both over
the window.  Nothing to read from a program without the counter."""


def read(window):
    posts = getattr(window.totals, "pbs_posts", None)
    calls = getattr(window.totals, "pbs_calls", None)
    if not posts or not calls:
        return None
    return posts / calls
