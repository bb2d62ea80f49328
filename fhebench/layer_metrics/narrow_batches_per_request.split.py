"""PBS batches of under 66 items a request (the program's ``record_pbs``
widths), mean over the window: a split's scan, one dependent batch of 2-3
items after another, where K2's cluster bodies run (66 clusters of 2 fit
an H100 at once)."""

NARROW = 66


def read(window):
    if not window.done or not window.widths:
        return None
    return sum(w < NARROW for w in window.widths) / len(window.done)
