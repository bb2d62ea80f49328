"""Requests completed over the whole window, a second: the window closes
at the end of the last request begun inside ``--seconds``."""


def read(window):
    return len(window.served) / window.window_s if window.done else None
