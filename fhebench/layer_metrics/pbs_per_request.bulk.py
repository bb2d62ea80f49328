"""Bootstraps a request runs (the program's ``pbs_items`` counter), mean
over the window."""


def read(window):
    rows = window.served
    return sum(d.pbs_items for d in rows) / len(rows) if rows else None
