"""Bootstraps of the window (the program's ``pbs_items`` counter) over its
seconds."""


def read(window):
    items = sum(d.pbs_items for d in window.done)
    return items / window.window_s if items else None
