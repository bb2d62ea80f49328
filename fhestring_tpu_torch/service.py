"""Serving layer: client/server over a real process boundary.

The JAX package's ``service.py`` on the port's keys and tensors, with its
wire format, so that a client of either package talks to a server of
either: a server owns only the evaluation keys and evaluates string methods
on serialized ciphertexts it receives over a socket; the client keeps the
secret keys and ships ciphertexts.  The payloads are the flat npz of
``serialize.py`` (no pickles).

Protocol (length-prefixed JSON header + npz payloads over TCP):

    client -> server: {"op": "contains", "clear_args": [...]} + cts
    server -> client: {"ok": true, "kind": "fhe_char"} + result ct

One request per connection, each connection on a thread of its own, so
that many clients are served at once: their requests run concurrently on
the one ``ServerKey``, whose shortint layer merges their bootstraps into
shared PBS batches (``batching``).  The listen backlog holds 256
connections, so clients do not wait on the accept queue.  The server runs
each request on the device its key lives on; a client's results land on
the device the ``RemoteServerKey`` was given.  On a card the server copies
a request's ciphertexts up without waiting (``torus.upload``) and reads
its result back with the thread asleep until the card has run it
(``torus.to_numpy``), so that the threads waiting on the card hold no CPU
core.

While the span recorder is on (``metrics.record_spans``) the client adds
its request id to the header (``"request"``), and both ends record their
spans under it: ``client.call`` around the round trip, with
``client.encode`` and ``client.decode`` inside; ``service.receive``,
``service.decode``, ``service.encode`` and ``service.send`` on the
server's thread around the ``server.<method>`` span.  A server of either
package ignores the key, and a request without it gets an id of its own.
"""

from __future__ import annotations

import io
import json
import socket
import socketserver
import struct
import threading

import numpy as np

from . import metrics, torus
from .ciphertext import FheChar, FheSplit, FheString, FheStrip
from .shortint import Blocks


def _send(sock: socket.socket, header: dict, blobs: list[bytes]) -> None:
    h = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(h)) + h)
    sock.sendall(struct.pack("<I", len(blobs)))
    for b in blobs:
        sock.sendall(struct.pack("<Q", len(b)) + b)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv(sock: socket.socket):
    hlen = struct.unpack("<I", _recv_exact(sock, 4))[0]
    header = json.loads(_recv_exact(sock, hlen))
    nblobs = struct.unpack("<I", _recv_exact(sock, 4))[0]
    blobs = []
    for _ in range(nblobs):
        blen = struct.unpack("<Q", _recv_exact(sock, 8))[0]
        blobs.append(_recv_exact(sock, blen))
    return header, blobs


def _ct_to_bytes(blocks: Blocks) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, ct=torus.to_numpy(blocks.ct), degree=blocks.degree,
             noise_var=blocks.noise_var)
    return buf.getvalue()


def _ct_from_bytes(b: bytes, device) -> Blocks:
    data = np.load(io.BytesIO(b), allow_pickle=False)
    return Blocks(torus.upload(torus.from_numpy(data["ct"]), device),
                  int(data["degree"]), float(data["noise_var"]))


def _pack_result(res):
    if isinstance(res, FheChar):
        return {"kind": "fhe_char"}, [_ct_to_bytes(res.blocks)]
    if isinstance(res, FheString):
        return {"kind": "fhe_string"}, [_ct_to_bytes(res.blocks)]
    if isinstance(res, FheStrip):
        return {"kind": "fhe_strip"}, [
            _ct_to_bytes(res.string.blocks),
            _ct_to_bytes(res.pattern_found.blocks)]
    if isinstance(res, FheSplit):
        return {"kind": "fhe_split"}, [
            _ct_to_bytes(res.buffers),
            _ct_to_bytes(res.pattern_found.blocks)]
    raise TypeError(type(res))


def _unpack_result(header, blobs, device):
    kind = header["kind"]
    blocks = [_ct_from_bytes(b, device) for b in blobs]
    if kind == "fhe_char":
        return FheChar(blocks[0])
    if kind == "fhe_string":
        return FheString(blocks[0])
    if kind == "fhe_strip":
        return FheStrip(FheString(blocks[0]), FheChar(blocks[1]))
    if kind == "fhe_split":
        return FheSplit(blocks[0], FheChar(blocks[1]))
    raise ValueError(kind)


# argument spec per op: "s" = FheString, "c" = FheChar, "S" = clear str,
# "I" = clear int
_OPS = {
    "contains": "ss", "contains_clear": "sS", "starts_with": "ss",
    "starts_with_clear": "sS", "ends_with": "ss", "ends_with_clear": "sS",
    "is_empty": "s", "len": "s", "eq": "ss", "ne": "ss",
    "eq_ignore_case": "ss", "lt": "ss", "le": "ss", "gt": "ss", "ge": "ss",
    "find": "ss", "find_clear": "sS", "rfind": "ss", "rfind_clear": "sS",
    "to_upper": "s", "to_lower": "s", "concatenate": "ss",
    "repeat": "sc", "repeat_clear": "sI", "replace": "sss",
    "replace_clear": "sSS", "replacen": "sssc", "replacen_clear": "sSSI",
    "trim": "s", "trim_start": "s", "trim_end": "s",
    "strip_prefix": "ss", "strip_prefix_clear": "sS",
    "strip_suffix": "ss", "strip_suffix_clear": "sS",
    "split": "ss", "split_clear": "sS", "split_inclusive": "ss",
    "split_inclusive_clear": "sS", "split_terminator": "ss",
    "split_terminator_clear": "sS", "splitn": "ssc", "splitn_clear": "sSI",
    "rsplit": "ss", "rsplit_clear": "sS", "rsplitn": "ssc",
    "rsplitn_clear": "sSI", "rsplit_once": "ss", "rsplit_once_clear": "sS",
    "rsplit_terminator": "ss", "rsplit_terminator_clear": "sS",
    "split_ascii_whitespace": "s",
}


class _ThreadingServer(socketserver.ThreadingTCPServer):
    """One daemon thread a connection; ``server_close`` joins none of
    them, so that ``stop`` returns at once.  The listen queue holds 256
    connections, so that a crowd of clients connecting at once is
    queued, not refused."""

    daemon_threads = True
    block_on_close = False
    request_queue_size = 256


class FheStringServer:
    """Owns a ServerKey (evaluation keys only); serves string methods on
    the device the key lives on, each connection on a thread of its own."""

    def __init__(self, server_key, host: str = "127.0.0.1", port: int = 0):
        self.server_key = server_key
        self.device = server_key.backend.sc.device
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with metrics.request() as req:
                    try:
                        with metrics.span("service.receive"):
                            header, blobs = _recv(self.request)
                            if req is not None:
                                req.join(header.get("request"))
                        res = outer._dispatch(header, blobs)
                        with metrics.span("service.encode"):
                            rh, rb = _pack_result(res)
                        rh["ok"] = True
                        with metrics.span("service.send"):
                            _send(self.request, rh, rb)
                    except Exception as e:  # report, don't kill the server
                        try:
                            _send(self.request,
                                  {"ok": False, "error": repr(e)}, [])
                        except OSError:  # the client has gone
                            pass

        self._tcp = _ThreadingServer((host, port), Handler)
        self.address = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)

    def _dispatch(self, header, blobs):
        op = header["op"]
        spec = _OPS[op]
        clear_args = list(header.get("clear_args", []))
        args = []
        bi = 0
        with metrics.span("service.decode"):
            for code in spec:
                if code in ("s", "c"):
                    blocks = _ct_from_bytes(blobs[bi], self.device)
                    args.append(FheString(blocks) if code == "s"
                                else FheChar(blocks))
                    bi += 1
                else:
                    v = clear_args.pop(0)
                    args.append(str(v) if code == "S" else int(v))
        return getattr(self.server_key, op)(*args)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._tcp.shutdown()
        self._tcp.server_close()


class RemoteServerKey:
    """Client-side proxy with the ServerKey method surface; each call is one
    round trip to a FheStringServer of either package.  Results are put on
    ``device`` (default: the card, as ``client.default_device``).
    timeout: seconds a connection may wait on the server (None: no
    limit)."""

    def __init__(self, address, *, device=None,
                 timeout: float | None = None):
        from .client import default_device

        self.address = address
        self.device = default_device(device)
        self.timeout = timeout

    def _call(self, op, *args):
        with metrics.request() as req, metrics.span("client.call"):
            with metrics.span("client.encode"):
                blobs, clear_args = [], []
                for a in args:
                    if isinstance(a, (FheString, FheChar)):
                        blobs.append(_ct_to_bytes(a.blocks))
                    else:
                        clear_args.append(a)
            header = {"op": op, "clear_args": clear_args}
            if req is not None:
                header["request"] = req.id
            with socket.create_connection(self.address,
                                          timeout=self.timeout) as sock:
                _send(sock, header, blobs)
                header, rblobs = _recv(sock)
            if not header.get("ok"):
                raise RuntimeError(header.get("error"))
            with metrics.span("client.decode"):
                return _unpack_result(header, rblobs, self.device)

    def __getattr__(self, name):
        if name not in _OPS:
            raise AttributeError(name)
        return lambda *args: self._call(name, *args)
