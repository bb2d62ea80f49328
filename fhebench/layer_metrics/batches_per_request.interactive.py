"""PBS batches a request dispatches (the program's ``pbs_calls`` counter),
mean over the window."""


def read(window):
    rows = window.served
    return sum(d.pbs_calls for d in rows) / len(rows) if rows else None
