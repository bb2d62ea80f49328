"""The share of the traced window, in %, in which no operation ran on the
card: one less the union of the operations' intervals (not their sum)
over the window."""


def read(window):
    tr = window.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
