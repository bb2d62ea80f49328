"""Mean per request of the time the service layer adds: the client's
clock around the ``RemoteServerKey`` call less the span of the
``ServerKey`` method the server ran (a benchmark-side proxy records it)."""


def read(window):
    rows = [d for d in window.served if d.method_ns is not None]
    if not rows:
        return None
    extra = [(d.end_ns - d.start_ns) - (d.method_ns[1] - d.method_ns[0])
             for d in rows]
    return sum(extra) / len(extra) / 1e6
