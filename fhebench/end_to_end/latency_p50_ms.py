"""Median time from sending a query to receiving its result ciphertext,
over every request of the window, in ms."""

import numpy as np


def read(window):
    lat = window.latencies_ms()
    return float(np.percentile(lat, 50)) if lat else None
