"""Bootstraps of the window over its seconds, from the program's
``pbs_items`` counter over the whole window (with several clients a
request's own count is not kept)."""


def read(window):
    items = getattr(window.totals, "pbs_items", None)
    if not items:
        return None
    return items / window.window_s
