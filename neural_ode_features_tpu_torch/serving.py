"""Client library for the serving hosts' socket transport (the port's copy
of the JAX package's ``serving.py``; numpy and sockets only).

``python -m neural_ode_features_tpu_torch.serve <artifact> --listen <addr>``
(the port's host) and ``native/pjrt_serve --listen <addr>`` (the JAX
package's C++ host) serve a model over a stream socket (AF_UNIX path or
``tcp:HOST:PORT``) with one small framed protocol; this module is the
Python side of that wire format, byte for byte the JAX package's, so either
client talks to either host.

Protocol (little-endian; authoritative comment: native/pjrt_serve.cc,
socket request loop; the port's host: ``serve.py``):

* hello (server→client, once per connection):
  ``u32 len`` + JSON ``{proto, dtype, in_shape, out_shape, in_bytes,
  out_bytes}``.
* request (client→server): ``u32 len`` + payload.  ``len == in_bytes``
  carries a raw row-major f32 tensor; ``len == 0`` closes the connection;
  ``len == 0xFFFFFFFF`` asks the server to shut down.  When the hello
  carries ``rows``/``row_bytes`` (artifact input and output share a batch
  dim), ``len`` may also be any multiple of ``row_bytes`` up to
  ``in_bytes`` — a RAGGED request of 1..B rows; the response then carries
  exactly that many output rows.
* response (server→client): ``u8 status`` + ``u32 len`` + payload.
  Status 0 → payload is the raw row-major f32 output tensor; status 1 →
  payload is an error message (the stream stays usable).

The server pipelines streamed requests at depth 2 (request *i* computes on
the device while the host stages *i+1*); :meth:`SocketClient.infer_stream`
exploits that by keeping two requests in flight.  Ragged requests also
COALESCE server-side (continuous batching): whatever is queued — across
all connections — is packed into one padded device batch per dispatch, so
many small clients share dispatches instead of each paying a full batch.
Coalescing is opportunistic: a lone request dispatches immediately, with
zero added latency.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Iterable, Iterator

import numpy as np

__all__ = ["SocketClient", "ServeError", "SHUTDOWN_FRAME"]

SHUTDOWN_FRAME = 0xFFFFFFFF


class ServeError(RuntimeError):
    """Status-1 response from the serving host (protocol-level error)."""


def _connect(address: str) -> socket.socket:
    if address.startswith("tcp:"):
        host, port = address[4:].rsplit(":", 1)
        conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.connect((host, int(port)))
    else:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(address)
    return conn


class SocketClient:
    """One connection to a serving host started with ``--listen``.

    >>> client = SocketClient("/tmp/serve.sock")      # or "tcp:host:port"
    >>> y = client.infer(x)                            # one round trip
    >>> for y in client.infer_stream(batches): ...     # depth-2 pipelined
    >>> client.close()                                 # or shutdown_server=True
    """

    def __init__(self, address: str):
        self.address = address
        self._conn = _connect(address)
        (hlen,) = struct.unpack("<I", self._recv(4))
        self.hello = json.loads(self._recv(hlen))
        if self.hello.get("proto") != "pjrt-serve-socket-1":
            raise ServeError(f"unexpected hello: {self.hello}")
        self.in_shape = tuple(self.hello["in_shape"])
        self.out_shape = tuple(self.hello["out_shape"])
        self.in_bytes = int(self.hello["in_bytes"])
        #: max rows per ragged request; 0 = server accepts full tensors only
        self.rows = int(self.hello.get("rows", 0))
        # Output rows expected per in-flight request, in request order
        # (None = the full tensor) — keeps responses reshapeable when
        # ragged and full requests interleave on one connection.
        self._pending_rows: list[int | None] = []

    # -- wire helpers ---------------------------------------------------------
    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the socket mid-frame")
            buf.extend(chunk)
        return bytes(buf)

    def _send_request(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.shape == self.in_shape:
            rows = None  # full tensor
        elif (self.rows and len(x.shape) == len(self.in_shape)
              and x.shape[1:] == self.in_shape[1:]
              and 1 <= x.shape[0] <= self.rows):
            rows = int(x.shape[0])  # ragged: 1..B rows
        else:
            hint = (f" or (1..{self.rows},)+{self.in_shape[1:]}"
                    if self.rows else "")
            raise ValueError(
                f"input shape {x.shape} != artifact shape "
                f"{self.in_shape}{hint}")
        self._conn.sendall(struct.pack("<I", x.nbytes))
        self._conn.sendall(x.tobytes())
        self._pending_rows.append(rows)

    def _recv_response(self) -> np.ndarray:
        rows = self._pending_rows.pop(0) if self._pending_rows else None
        status = self._recv(1)[0]
        (length,) = struct.unpack("<I", self._recv(4))
        payload = self._recv(length)
        if status != 0:
            raise ServeError(payload.decode(errors="replace"))
        shape = self.out_shape if rows is None else (
            (rows,) + self.out_shape[1:])
        return np.frombuffer(payload, np.float32).reshape(shape)

    # -- public API -----------------------------------------------------------
    def infer(self, x: np.ndarray) -> np.ndarray:
        """One request, one response (client-side round trip).

        ``x`` is either the artifact's full input shape or — when the
        hello advertises ``rows`` — a ragged ``(r,) + in_shape[1:]`` with
        ``1 <= r <= rows``; the answer then has ``(r,) + out_shape[1:]``.
        """
        self._send_request(x)
        return self._recv_response()

    def infer_stream(self, xs: Iterable[np.ndarray],
                     depth: int = 2) -> Iterator[np.ndarray]:
        """Yield outputs in request order, keeping ``depth`` requests in
        flight (2 = the server's pipeline depth; the chip computes request
        *i* while the host stages *i+1*).  Bounded in-flight depth also
        avoids the both-buffers-full deadlock a fire-everything writer
        would risk with large tensors."""
        it = iter(xs)
        in_flight = 0
        while True:
            while in_flight < depth:
                try:
                    self._send_request(next(it))
                except StopIteration:
                    break
                in_flight += 1
            if in_flight == 0:
                return
            yield self._recv_response()
            in_flight -= 1

    def infer_burst(self, xs: Iterable[np.ndarray]) -> list[np.ndarray]:
        """Send ALL requests up front, draining responses concurrently;
        returns the outputs in request order.

        This is the single-stream face of the server's continuous
        batching: :meth:`infer_stream`'s depth-2 window never leaves more
        than one request queued server-side, so a lone connection's ragged
        requests are dispatched one per device batch.
        Bursting floods the server's per-connection queue, and its batch
        assembler packs as many queued requests as fit into each padded
        dispatch — response order is preserved by the protocol (the server
        answers per connection strictly in request order).

        Deadlock safety (the reason ``infer_stream`` bounds its depth): a
        fire-everything writer over a blocking socket can fill BOTH kernel
        buffers — client blocked in send, server blocked in its response
        write — and stall forever.  This method never blocks in send: it
        ``select``-interleaves nonblocking writes of the remaining request
        bytes with reads of whatever responses have arrived, so the
        server's responses always drain no matter how large the burst.
        """
        import select as _select

        payloads = []
        for x in xs:
            x = np.ascontiguousarray(x, dtype=np.float32)
            # _send_request's shape/rows validation, without the send.
            if x.shape == self.in_shape:
                rows = None
            elif (self.rows and len(x.shape) == len(self.in_shape)
                  and x.shape[1:] == self.in_shape[1:]
                  and 1 <= x.shape[0] <= self.rows):
                rows = int(x.shape[0])
            else:
                hint = (f" or (1..{self.rows},)+{self.in_shape[1:]}"
                        if self.rows else "")
                raise ValueError(
                    f"input shape {x.shape} != artifact shape "
                    f"{self.in_shape}{hint}")
            payloads.append(struct.pack("<I", x.nbytes) + x.tobytes())
            self._pending_rows.append(rows)
        n = len(payloads)
        if n == 0:
            return []
        out_buf = memoryview(b"".join(payloads))
        rbuf = bytearray()
        results: list[np.ndarray] = []
        # Widen the send buffer (best effort; kernel clamps to wmem_max,
        # 208 KB default = HALF of one 32-row CIFAR frame).  The server's
        # coalescing factor is bounded by how many whole frames sit in the
        # kernel queue when it assembles a batch (the JAX package's
        # RESULTS.md r5 explains it).
        try:
            self._conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                  4 << 20)
        except OSError:
            pass
        self._conn.setblocking(False)
        try:
            while len(results) < n:
                want_write = len(out_buf) > 0
                readable, writable, _ = _select.select(
                    [self._conn], [self._conn] if want_write else [], [],
                    30.0,
                )
                if not readable and not writable:
                    raise TimeoutError(
                        f"infer_burst stalled: {len(results)}/{n} responses"
                        f" after 30 s with {len(out_buf)} B unsent")
                if writable:
                    try:
                        sent = self._conn.send(out_buf)
                        out_buf = out_buf[sent:]
                    except BlockingIOError:
                        pass
                if readable:
                    try:
                        chunk = self._conn.recv(1 << 20)
                    except BlockingIOError:
                        chunk = None
                    if chunk == b"":
                        raise ConnectionError(
                            "server closed the socket mid-burst")
                    if chunk:
                        rbuf.extend(chunk)
                # Parse every complete response frame in the buffer.
                while True:
                    if len(rbuf) < 5:
                        break
                    status = rbuf[0]
                    (length,) = struct.unpack_from("<I", rbuf, 1)
                    if len(rbuf) < 5 + length:
                        break
                    payload = bytes(rbuf[5:5 + length])
                    del rbuf[:5 + length]
                    rows = (self._pending_rows.pop(0)
                            if self._pending_rows else None)
                    if status != 0:
                        raise ServeError(payload.decode(errors="replace"))
                    shape = self.out_shape if rows is None else (
                        (rows,) + self.out_shape[1:])
                    results.append(
                        np.frombuffer(payload, np.float32).reshape(shape))
        finally:
            self._conn.setblocking(True)
        return results

    def close(self, shutdown_server: bool = False) -> None:
        try:
            frame = SHUTDOWN_FRAME if shutdown_server else 0
            self._conn.sendall(struct.pack("<I", frame))
        except OSError:
            pass
        self._conn.close()

    def __enter__(self) -> "SocketClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
