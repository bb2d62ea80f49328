"""Mean logical width, in items, of the PBS batches dispatched in the
window (the widths the program's ``record_pbs`` sees: one a dispatch,
merged across requests where the server merged them)."""


def read(window):
    if not window.widths:
        return None
    return sum(window.widths) / len(window.widths)
