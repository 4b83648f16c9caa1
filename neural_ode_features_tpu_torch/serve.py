"""The port's serving host: an ``export-compiled`` artifact held on the card,
answered over stdin or a socket (the counterpart of the JAX package's C++
host ``native/pjrt_serve.cc``, with its command line, output lines, wire
protocol and batching).

    python -m neural_ode_features_tpu_torch.serve <artifact_dir> [--selftest]
        [--bench N] [--serve] [--input X.npy] [--output Y.npy] [--tol T]
        [--deadline S] [--imgs N] [--listen PATH | tcp:HOST:PORT] [--cpu]

The C++ host runs a serialized executable with no Python in the process.
This one is a Python process that holds the weights and runs the port's
model code: the port has no ahead-of-time executable of an adaptive solve,
whose attempt loop runs on the host.  The artifact
(``export_model.py``) carries the weights in place of the executable.  On
the card the ODE-Net runs the kernels (``odefunc``, ``rk_step``; a bf16
run, ``compute_dtype='bfloat16'``, the ODEfunc kernel's bf16 build and no
fused step) or the host exits before ``READY``; ``--cpu`` is the only way
onto the plain path.  An ``export-mock`` artifact (``format:
mock-pjrt-descriptor``) is answered with the compute of the native host's
mock plugin (:func:`mock_fn`).

Modes, in the C++ host's order: the first execution on ``sample_input.npy``
(or ``--input``) warms the model up; ``--selftest`` compares it with
``expected_logits.npy`` (``SELFTEST OK max_diff=... batch=...``, else exit
2); ``--bench N`` times N executions of a resident input and prints one JSON
line; ``--output`` writes the first execution's logits; then ``--serve``
answers one ``<in.npy> <out.npy>`` line per request on stdin (``OK <out.npy>
<secs>`` or ``ERR <msg>``), or ``--listen`` serves the socket protocol of
``serving.py`` (``READY <addr>``).  ``--deadline`` bounds the startup only.
Usage and artifact errors fail before the model loads.  ``--plugin`` is
accepted for the JAX client's sake, empty only: this host loads no plugin.

Execution is depth-2 pipelined on two threads.  The host's thread reads the
sockets (or stdin), assembles batches into pinned host buffers and starts
their copies to the card on a side stream; the compute thread solves one
batch at a time.  So batch i+1 is read and staged while batch i solves,
though the solve syncs with the host once per attempt.

Continuous batching (only when ``meta.json`` says ``rowwise``): ragged
requests of 1..B rows from every connection are packed in dispatch order
into one batch, padded to B rows; a partial batch waits while any open
connection still has unread bytes, and a lone request dispatches at once.
At shutdown the host prints its totals on one line of stderr: flights,
requests and rows, the compute thread's solve time, a histogram of attempts
(``rk_step`` launches; a bf16 run's (``odefunc_bf16`` − 2) / 6) per
dispatch and the kernel launch counters (set to 0 when serving starts).  ``SIGUSR1`` prints the same totals while it serves
(``listen: stats {...}``), so that a client can read them between phases.

Both loops warm the compute thread's path (side stream, every pinned
buffer) with the artifact's input before they print ``READY``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import queue
import select
import signal
import socket
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ._device import strict_f32
from .export_model import load_artifact, logits_fn, mock_expected
from .kernels.odefunc import odefunc
from .kernels.odefunc_bwd import odefunc_bwd
from .kernels.rk_step import dopri5_step

__all__ = ["main", "read_npy", "Engine", "kernel_counts", "mock_fn"]

PROTO = "pjrt-serve-socket-1"
MOCK_FORMAT = "mock-pjrt-descriptor"
SHUTDOWN = 0xFFFFFFFF
DEPTH = 2                    # batches in flight: one solving, one staged
CHUNK = 1 << 16              # a sink read; the drain's bound past B
MAX_FRAME = 64 << 20         # a longer frame cannot be trusted: close
SOCK_BUF = 4 << 20           # SO_RCVBUF of accepted sockets
T0 = time.perf_counter()


def mock_fn(meta: dict):
    """The mock plugin's compute (``native/mock_pjrt_plugin.cc``) for a
    ``mock-pjrt-descriptor`` artifact, as the native host serves it with
    that plugin: ``export_model.mock_expected`` on the input's device.  The
    plugin's ``layout: reversed`` hands back column-major bytes that the
    native host puts back in row-major order, so the answer does not depend
    on it."""
    args = (tuple(meta["outputs"][0]["shape"]), float(meta["scale"]),
            float(meta["shift"]), meta.get("mode", "flat"))

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return mock_expected(x, *args)
    return fn


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


class Fatal(Exception):
    """A startup or serving fault: ``serve: FATAL: <msg>``, exit 1."""


def kernel_counts() -> dict:
    """The launch counters: the f32 builds' always, the bf16 ODEfunc
    build's (a bf16 run's dynamics) where it launched."""
    bf16 = {"odefunc_bf16": odefunc.launches_bf16}
    return {"odefunc": odefunc.launches, "rk_step": dopri5_step.launches,
            "odefunc_bwd": odefunc_bwd.launches,
            **{k: v for k, v in bf16.items() if v}}


def _launched(before: dict) -> dict:
    """The launches since ``before`` (:func:`kernel_counts`)."""
    return {k: v - before.get(k, 0) for k, v in kernel_counts().items()}


def _attempts(launched: dict) -> int:
    """The dopri5 attempts of one dispatch: its fused-step launches, or for
    bf16 dynamics (no fused step) its 2 + 6·attempts ODEfunc launches."""
    if "odefunc_bf16" in launched:
        return (launched["odefunc_bf16"] - 2) // 6
    return launched["rk_step"]


def _reset_counts() -> None:
    odefunc.launches = dopri5_step.launches = odefunc_bwd.launches = 0
    odefunc.launches_bf16 = 0


def read_npy(path: str) -> np.ndarray:
    """A ``.npy`` file's array, header first: no pickles, and the data is
    read only after the header's dtype (``<f4``), order (C) and size have
    been checked, so a hostile header raises ``ValueError`` before anything
    is allocated."""
    try:
        f = open(path, "rb")
    except OSError:
        raise ValueError(f"cannot open {path}") from None
    with f:
        try:
            version = np.lib.format.read_magic(f)
            read = {(1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0}.get(version)
            if read is None:
                raise ValueError(f"unsupported .npy version {version}")
            shape, fortran, dtype = read(f)
        except (ValueError, TypeError, SyntaxError, OverflowError) as e:
            raise ValueError(f"{path}: malformed npy header ({e})") from None
        if dtype.str != "<f4":
            raise ValueError(f"only <f4 inputs supported, got {dtype.str}")
        if fortran:
            raise ValueError(f"{path}: fortran_order arrays unsupported")
        n = 1
        for d in shape:
            n *= d
        if n * 4 > 1 << 31:
            raise ValueError(f"{path}: shape too large")
        data = np.fromfile(f, dtype="<f4", count=n)
        if data.size != n:
            raise ValueError(f"{path}: truncated data")
        return data.reshape(shape)


def write_npy(path: str, arr: np.ndarray) -> bool:
    try:
        with open(path, "wb") as f:  # the exact path: np.save adds '.npy'
            np.save(f, arr)
        return True
    except OSError:
        return False


class Job:
    """One batch on its way through the compute thread."""

    def __init__(self, x, ready, buf):
        self.x, self.ready, self.buf = x, ready, buf
        self.done = threading.Event()
        self.out: np.ndarray | None = None
        self.error: BaseException | None = None
        self.launches: dict = {}
        self.ms = 0.0                 # the solve, logits on the host


class Engine:
    """The model on its own thread, batch after batch, fed through ``DEPTH``
    host buffers (pinned on the card) whose copies run on a side stream."""

    def __init__(self, fn, shape: tuple, dev: torch.device, on_done=None):
        self.fn, self.dev, self.on_done = fn, dev, on_done
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.free: queue.Queue = queue.Queue()
        for _ in range(DEPTH):
            self.free.put(torch.empty(shape, dtype=torch.float32,
                                      pin_memory=self.cuda))
        self.jobs: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._loop, name="compute",
                                       daemon=True)
        self.thread.start()

    def submit(self, fill) -> Job:
        """Take a free host buffer, let ``fill(view)`` write the batch into
        its numpy view, start the copy to the device and queue the solve."""
        buf = self.free.get()
        fill(buf.numpy())
        if self.cuda:
            with torch.cuda.stream(self.stream):
                x = buf.to(self.dev, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self.stream)
        else:
            x, ready = buf, None
        job = Job(x, ready, buf)
        self.jobs.put(job)
        return job

    def _loop(self) -> None:
        while (job := self.jobs.get()) is not None:
            try:
                if job.ready is not None:
                    compute = torch.cuda.current_stream(self.dev)
                    compute.wait_event(job.ready)
                    job.x.record_stream(compute)
                before, t0 = kernel_counts(), time.perf_counter()
                job.out = np.ascontiguousarray(self.fn(job.x).cpu().numpy())
                job.ms = 1e3 * (time.perf_counter() - t0)
                job.launches = _launched(before)
            except Exception as e:  # raised in the host's thread by result()
                job.error = e
            job.x = None
            self.free.put(job.buf)
            job.done.set()
            if self.on_done is not None:
                self.on_done()

    def warm(self, x: np.ndarray) -> None:
        """Run ``x`` through every host buffer and the compute thread, so
        that the first request meets a warm path (its stream's allocations,
        the pinned buffers' first copies)."""
        for job in [self.submit(lambda view: np.copyto(view, x))
                    for _ in range(DEPTH)]:
            result(job)

    def close(self) -> None:
        self.jobs.put(None)
        self.thread.join(timeout=60)


def result(job: Job) -> np.ndarray:
    job.done.wait()
    if job.error is not None:
        raise Fatal(f"execute failed: {job.error!r}") from job.error
    return job.out


class Watchdog:
    """``--deadline``: name the stuck startup phase and exit 3 once the
    deadline passes (the C++ host's watchdog)."""

    def __init__(self, seconds: float):
        self.phase = "startup"
        self.off = threading.Event()
        if seconds > 0:
            threading.Thread(target=self._run, args=(seconds,),
                             daemon=True).start()

    def _run(self, seconds: float) -> None:
        if self.off.wait(max(0.0, seconds - (time.perf_counter() - T0))):
            return
        print(f"serve: DEADLINE ({seconds:.0f}s) exceeded in phase "
              f"'{self.phase}'", file=sys.stderr, flush=True)
        print(json.dumps({"error": "deadline", "phase": self.phase}),
              flush=True)
        os._exit(3)


# ------------------------------------------------------------ stdin loop --

class _Lines:
    """Lines of stdin read from the file descriptor, so that the loop can
    tell whether the client has already queued the next request."""

    def __init__(self, fd: int = 0):
        self.fd, self.buf = fd, bytearray()

    def has_bytes(self) -> bool:
        return bool(self.buf) or bool(select.select([self.fd], [], [], 0)[0])

    def readline(self) -> str | None:
        while b"\n" not in self.buf:
            chunk = os.read(self.fd, 1 << 16)
            if not chunk:
                if not self.buf:
                    return None
                line = bytes(self.buf)
                self.buf.clear()
                return line.decode(errors="replace")
            self.buf += chunk
        i = self.buf.index(b"\n")
        line = bytes(self.buf[:i])
        del self.buf[:i + 1]
        return line.decode(errors="replace")


def serve_stdin(fn, dev: torch.device, x: np.ndarray) -> None:
    """One ``<in.npy> <out.npy>`` pair per line; answers in request order.
    A request whose line follows at once is read and staged before the
    answer to the one before it is written (in-flight depth 2)."""
    engine = Engine(fn, x.shape, dev)
    try:
        engine.warm(x)
        _stdin_loop(engine, x.shape)
    finally:
        engine.close()


def _stdin_loop(engine: Engine, in_shape: tuple) -> None:
    pending: collections.deque = collections.deque()
    lines = _Lines()

    def emit(text: str) -> None:
        print(text, flush=True)

    def complete_oldest() -> None:
        job, out_path, t_req = pending.popleft()
        y = result(job)
        if write_npy(out_path, y):
            emit(f"OK {out_path} {time.perf_counter() - t_req:.4f}")
        else:
            emit(f"ERR failed to write {out_path}")

    def drain() -> None:
        while pending:
            complete_oldest()

    log("serve: ready (one '<in.npy> <out.npy>' pair per line; pipelined "
        "when requests are streamed)")
    emit("READY")
    while True:
        if pending and not lines.has_bytes():
            drain()
        line = lines.readline()
        if line is None or line == "" or line == "quit":
            break
        in_path, sep, out_path = line.partition(" ")
        if not sep:
            drain()
            emit("ERR expected '<in.npy> <out.npy>'")
            continue
        t_req = time.perf_counter()
        try:
            x = read_npy(in_path)
        except ValueError as e:
            drain()
            emit(f"ERR {e}")
            continue
        if x.shape != in_shape:
            drain()
            emit("ERR input must be <f4 with the artifact's shape")
            continue
        job = engine.submit(lambda view, x=x: np.copyto(view, x))
        pending.append((job, out_path, t_req))
        if len(pending) >= DEPTH:
            complete_oldest()
    drain()
    log("serve: loop ended")


# ----------------------------------------------------------- socket loop --

class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        # The frame being received: its 4-byte length, then its payload,
        # read straight into a buffer of that length (no copies).
        self.head = bytearray(4)
        self.body: bytearray | None = None
        self.got = 0                  # bytes of the head or body received
        self.rows = 0                 # rows of the body (0 = full tensor)
        self.discard = 0              # bytes of a wrong-length frame to sink
        self.discard_err = ""         # ERR queued once the sink completes
        # parsed work, strictly ordered: (payload, rows, err); rows 0 = the
        # full tensor, payload None = an error answer
        self.queue: collections.deque = collections.deque()
        self.in_flight = 0            # this connection's requests dispatched
        self.draining = False         # saw close/shutdown/EOF: no more reads
        self.open = True              # still writable

    def readable(self) -> bool:
        return bool(select.select([self.sock], [], [], 0)[0])

    def send(self, status: int, payload) -> None:
        if not self.open:
            return
        try:
            self.sock.sendall(struct.pack("<BI", status, len(payload))
                              + bytes(payload))
        except OSError:  # a dead client; other work still retires
            self.open = False
            self.draining = True


def _listener(addr: str) -> socket.socket:
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        if not host or not port.isdigit() or not 0 < int(port) < 65536:
            raise Fatal(f"--listen tcp spec must be tcp:HOST:PORT, got {addr}")
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        target = (host, int(port))
    else:
        if len(addr.encode()) > 107:
            raise Fatal("--listen path too long for AF_UNIX (107 bytes max)")
        if os.path.exists(addr):
            os.unlink(addr)
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        target = addr
    try:
        lsock.bind(target)
        lsock.listen(8)
    except OSError as e:
        lsock.close()
        raise Fatal(f"bind {addr}: {e}") from None
    return lsock


def serve_socket(fn, dev: torch.device, addr: str, x: np.ndarray,
                 y: np.ndarray, rowwise: bool) -> dict:
    """The C++ host's socket loop: per-connection ordered queues, coalesced
    dispatch of ragged requests, depth-2 in flight.  ``x`` and ``y`` are the
    artifact's input and the model's output on it (their shapes are the
    hello's).  Returns the coalescing statistics."""
    in_bytes, out_bytes = x.nbytes, y.nbytes
    max_rows = (x.shape[0] if rowwise and x.ndim and y.ndim
                and x.shape[0] == y.shape[0] and x.shape[0] > 0 else 0)
    row_bytes = in_bytes // max_rows if max_rows else 0
    out_row_bytes = out_bytes // max_rows if max_rows else 0
    hello = (f'{{"proto": "{PROTO}", "dtype": "<f4", "in_shape": ['
             + ",".join(map(str, x.shape)) + '], "out_shape": ['
             + ",".join(map(str, y.shape)) + f'], "in_bytes": {in_bytes}, '
             f'"out_bytes": {out_bytes}')
    if max_rows:
        hello += (f', "rows": {max_rows}, "row_bytes": {row_bytes}, '
                  f'"out_row_bytes": {out_row_bytes}')
    hello = (hello + "}").encode()

    sink = bytearray(CHUNK)
    wake_r, wake_w = os.pipe()
    os.set_blocking(wake_r, False)
    engine = Engine(fn, x.shape, dev, lambda: os.write(wake_w, b"."))
    engine.warm(x)
    lsock = _listener(addr)
    is_tcp = addr.startswith("tcp:")

    conns: list[_Conn] = []
    flights: collections.deque = collections.deque()  # (job, segs)
    shutdown = False
    rr = 0
    # Totals only, so that a long-lived host holds a bounded record:
    # attempts maps the attempts of a dispatch to the dispatches that took
    # that many.
    stats = {"flights": 0, "requests": 0, "rows": 0, "solve_ms": 0.0,
             "attempts": {}}
    _reset_counts()

    # SIGUSR1 reaches the loop through the interpreter's wakeup pipe, which
    # the C-level handler writes in whichever thread the OS handed it to: the
    # Python handler runs only in this thread, and not while it waits in
    # select() if another thread took the signal.  One byte per signal.
    sig_r, sig_w = os.pipe()
    os.set_blocking(sig_r, False)
    os.set_blocking(sig_w, False)
    old_wakeup = signal.set_wakeup_fd(sig_w, warn_on_full_buffer=False)

    def on_usr1(signum, frame) -> None:
        pass  # the byte in sig_r is the report

    def totals() -> str:
        return json.dumps({**stats, "solve_ms": round(stats["solve_ms"], 3),
                           "launches": kernel_counts()})

    old_usr1 = signal.signal(signal.SIGUSR1, on_usr1)
    log(f"listen: ready on {addr} (in {in_bytes} B, out {out_bytes} B per "
        "request)")
    print(f"READY {addr}", flush=True)

    def on_length(c: _Conn, n: int) -> None:
        nonlocal shutdown
        if n == 0:  # close frame: answer what is queued, then close
            c.draining = True
        elif n == SHUTDOWN:
            c.draining = shutdown = True
        elif n == in_bytes or (max_rows and n < in_bytes
                               and n % row_bytes == 0):
            c.body, c.rows = bytearray(n), n // row_bytes if n < in_bytes else 0
        elif n > MAX_FRAME:
            c.queue.append((None, 0, f"frame length {n} exceeds sanity cap; "
                            "closing"))
            c.draining = True  # the stream cannot be trusted
        else:
            c.discard = n
            c.discard_err = (
                f"expected {in_bytes} bytes (f32, artifact input shape)"
                + (f" or a multiple of {row_bytes} (1..{max_rows} rows)"
                   if max_rows else "") + f", got {n}")

    def receive(c: _Conn) -> None:
        """Turn what the socket holds into queued frames, without blocking.
        Drains the kernel's buffer (bounded per cycle, so that one firehose
        cannot starve the others): coalescing needs whole frames queued
        before the dispatch decision."""
        drained = 0
        while not c.draining and drained < in_bytes + CHUNK:
            if c.discard:  # sinking a wrong-length frame's payload
                view = memoryview(sink)[:min(c.discard, len(sink))]
            elif c.body is not None:
                view = memoryview(c.body)[c.got:]
            else:
                view = memoryview(c.head)[c.got:]
            try:
                n = c.sock.recv_into(view, 0, socket.MSG_DONTWAIT)
            except BlockingIOError:
                break
            except OSError:
                n = 0
            if n == 0:  # EOF: answer what is queued, then close
                c.draining = True
                break
            drained += n
            if c.discard:
                c.discard -= n
                if not c.discard:
                    c.queue.append((None, 0, c.discard_err))
                continue
            c.got += n
            if c.body is not None and c.got == len(c.body):
                c.queue.append((c.body, c.rows, ""))
                c.body, c.got = None, 0
            elif c.body is None and c.got == 4:
                c.got = 0
                on_length(c, struct.unpack("<I", c.head)[0])

    def queued_input_bytes() -> int:
        return sum(len(p) for c in conns for p, _, _ in c.queue
                   if p is not None)

    def fill_batch(parts: list, used: int):
        def fill(view: np.ndarray) -> None:
            flat = view.reshape(-1).view(np.uint8)
            off = 0
            for p in parts:
                flat[off:off + len(p)] = np.frombuffer(p, np.uint8)
                off += len(p)
            if used < in_bytes:
                # Pad with copies of the batch's first row, not zeros: the
                # solve runs until every row is done, so a padding row
                # that needed more attempts than the real rows would
                # lengthen the dispatch.  The real rows' answers are the
                # same either way (the artifact is row-independent).
                view[used // row_bytes:] = view[0]
        return fill

    def try_dispatch(input_dry: bool) -> None:
        nonlocal rr
        n = len(conns)
        while n and len(flights) < DEPTH:
            if not input_dry and queued_input_bytes() < in_bytes:
                break  # more bytes are about to be parsed: let it fill
            segs, parts, used = [], [], 0
            for k in range(n):
                c = conns[(rr + k) % n]
                staged_here = False
                while c.queue:
                    payload, rows, err = c.queue[0]
                    if payload is None:
                        # An ERR must not overtake this connection's
                        # earlier answers, dispatched or being staged.
                        if c.in_flight or staged_here:
                            break
                        c.send(1, err.encode())
                        c.queue.popleft()
                        continue
                    if used + len(payload) > in_bytes:
                        break  # no room in this batch
                    parts.append(payload)
                    used += len(payload)
                    segs.append((c, rows))
                    stats["requests"] += 1
                    stats["rows"] += rows or max_rows
                    c.in_flight += 1
                    staged_here = True
                    c.queue.popleft()
            if not segs:
                break
            if len(segs) > 1:
                log(f"listen: coalesced {len(segs)} requests into one batch "
                    f"({used}/{in_bytes} B)")
            flights.append((engine.submit(fill_batch(parts, used)), segs))
            stats["flights"] += 1
            rr = (rr + 1) % n

    def retire() -> None:
        while flights and flights[0][0].done.is_set():
            job, segs = flights.popleft()
            out = memoryview(result(job)).cast("B")
            stats["solve_ms"] += job.ms
            n_att = str(_attempts(job.launches))
            stats["attempts"][n_att] = stats["attempts"].get(n_att, 0) + 1
            off = 0
            for c, rows in segs:
                nbytes = rows * out_row_bytes if rows else out_bytes
                c.in_flight -= 1
                c.send(0, out[off:off + nbytes])
                off += nbytes

    try:
        while True:
            if shutdown:
                # Answer what is already dispatched, then stop; queued
                # requests are dropped (an administrative kill).
                while flights:
                    flights[0][0].done.wait()
                    retire()
                break
            rlist = [lsock, wake_r, sig_r] + [c.sock for c in conns
                                              if c.open and not c.draining]
            ready = set(select.select(rlist, [], [])[0])
            if wake_r in ready:
                try:
                    os.read(wake_r, 1 << 12)
                except BlockingIOError:
                    pass
            if sig_r in ready:
                try:
                    sigs = os.read(sig_r, 1 << 12)
                except BlockingIOError:
                    sigs = b""
                if signal.SIGUSR1 in sigs:
                    log(f"listen: stats {totals()}")
            if lsock in ready:
                sock, _ = lsock.accept()
                try:
                    # Widen the receive queue: how many whole frames wait
                    # in it when a batch is assembled bounds coalescing.
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    SOCK_BUF)
                    if is_tcp:
                        sock.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                    sock.sendall(struct.pack("<I", len(hello)) + hello)
                    conns.append(_Conn(sock))
                    log(f"listen: client connected ({len(conns)} open)")
                except OSError:
                    sock.close()
            for c in [c for c in conns if c.sock in ready]:
                receive(c)
            input_dry = not any(c.open and not c.draining and c.readable()
                                for c in conns)
            retire()
            try_dispatch(input_dry)
            for c in [c for c in conns if c.draining and not c.queue
                      and not c.in_flight]:
                c.sock.close()
                conns.remove(c)
                log(f"listen: connection closed ({len(conns)} open)")
    finally:
        signal.signal(signal.SIGUSR1, old_usr1)
        signal.set_wakeup_fd(old_wakeup)
        engine.close()
        for c in conns:
            c.sock.close()
        lsock.close()
        for fd in (wake_r, wake_w, sig_r, sig_w):
            os.close(fd)
        if not is_tcp and os.path.exists(addr):
            os.unlink(addr)
    log(f"listen: loop ended{' (shutdown)' if shutdown else ''} — "
        f"{stats['requests']} requests ({stats['rows']} rows) in "
        f"{stats['flights']} dispatches; stats {totals()}")
    return {**stats, "launches": kernel_counts()}


# ------------------------------------------------------------------ main --

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m neural_ode_features_tpu_torch.serve",
        description=__doc__.split("\n\n")[0])
    p.add_argument("artifact",
                   help="an export-compiled or export-mock directory")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--bench", type=int, default=0)
    p.add_argument("--serve", action="store_true",
                   help="answer '<in.npy> <out.npy>' lines on stdin")
    p.add_argument("--listen", default="",
                   help="serve the socket protocol: a unix path or "
                        "tcp:HOST:PORT")
    p.add_argument("--input", default="")
    p.add_argument("--output", default="")
    p.add_argument("--tol", type=float, default=1e-5,
                   help="--selftest's bound on max|logits - expected|")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="seconds the startup may take (exit 3 past it)")
    p.add_argument("--imgs", type=int, default=0,
                   help="images per request for --bench (default: the "
                        "batch, or chain x batch)")
    p.add_argument("--plugin", default="",
                   help="accepted empty only: this host loads no plugin")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU through the plain path")
    return p.parse_args(argv)


def run(args) -> int:
    watchdog = Watchdog(args.deadline)
    if args.plugin:
        raise Fatal(f"--plugin {args.plugin}: the port's host loads no PJRT "
                    "plugin; it serves the artifact's weights with the "
                    "port's kernels (--cpu: the plain path)")
    if args.serve and args.listen:
        raise Fatal("--serve (stdin) and --listen (socket) are mutually "
                    "exclusive")
    if args.selftest and args.input:
        raise Fatal("--selftest compares against the artifact's "
                    "expected_logits for its OWN sample_input; it cannot "
                    "be combined with --input")

    # Validate the artifact before the model loads or the card is touched.
    art = Path(args.artifact)
    try:
        meta = json.loads((art / "meta.json").read_text())
        mock = meta.get("format") == MOCK_FORMAT
        weights = art / ("executable.bin" if mock
                         else meta.get("weights", "weights.pt"))
        in_shape = tuple(meta["inputs"][0]["shape"])
    except OSError:
        raise Fatal(f"cannot open {art / 'meta.json'}") from None
    except (ValueError, LookupError, TypeError, AttributeError) as e:
        raise Fatal(f"{art / 'meta.json'}: malformed ({e!r})") from None
    if not weights.is_file():
        raise Fatal(f"cannot open {weights}")
    try:
        x = read_npy(args.input or str(art / "sample_input.npy"))
    except ValueError as e:
        raise Fatal(str(e)) from None
    if x.shape != in_shape:
        raise Fatal(f"input shape {x.shape} != the artifact's {in_shape}")
    chain = int(meta.get("chain", 1))
    imgs = args.imgs or (chain * x.shape[1] if chain > 1 and x.ndim >= 2
                         else x.shape[0])
    log(f"artifact ok: weights {weights.stat().st_size / 1e6:.2f} MB, input "
        f"{x.size} elems, batch {x.shape[0]}")

    watchdog.phase = "device"
    try:
        dev = strict_f32("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        raise Fatal(f"{e} (the host's flag: --cpu)") from None
    watchdog.phase = "model load"
    if mock:
        fn, model = mock_fn(meta), "mock"
        log(f"model: mock ({meta.get('mode', 'flat')}, scale "
            f"{meta['scale']}, shift {meta['shift']}), on {dev}")
    else:
        params, cfg, model = load_artifact(art, meta, dev)
        fn = logits_fn(params, cfg, model, chain)
        log(f"model: {model}, hidden {cfg.hidden}, {cfg.method} "
            f"{cfg.error_control} tol {cfg.tol:g}, on {dev}")

    watchdog.phase = "first execute + output fetch"
    t_first = time.perf_counter()
    before = kernel_counts()
    xd = torch.from_numpy(x).to(dev)
    y = np.ascontiguousarray(fn(xd).cpu().numpy())
    launched = _launched(before)
    log(f"first execute: {time.perf_counter() - t_first:.3f} s (includes "
        f"the kernels' build and warm-up); launches {launched}")
    bf16 = model == "odenet" and cfg.compute_dtype == "bfloat16"
    fused = (model == "odenet" and cfg.method == "dopri5"
             and cfg.error_control == "per_sample" and not bf16)
    f = launched.get("odefunc_bf16", 0) if bf16 else launched["odefunc"]
    if dev.type == "cuda" and model == "odenet" and not (
            f and (launched["rk_step"] or not fused)):
        raise Fatal(f"the ODE-Net ran without its kernels on the card "
                    f"(launches {launched})")
    watchdog.phase = "post-warmup"

    rc = 0
    if args.selftest:
        exp = read_npy(str(art / "expected_logits.npy"))
        if exp.shape != y.shape:
            raise Fatal("selftest: output size mismatch")
        maxd = float(np.abs(y.astype(np.float64) - exp).max())
        a, b = y.reshape(-1, y.shape[-1]), exp.reshape(-1, y.shape[-1])
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"selftest: max|diff| = {maxd:.3e}, argmax agreement "
            f"{agree}/{len(a)}")
        if maxd > args.tol or agree != len(a):
            print(f"SELFTEST FAILED (tol {args.tol:.1e})", file=sys.stderr,
                  flush=True)
            rc = 2
        else:
            print(f"SELFTEST OK max_diff={maxd:.3e} batch={len(a)}",
                  flush=True)

    if args.bench > 0:
        # Per-request latency with the input resident on the device: one
        # execution and the fetch of its logits, which is the sync point.
        lat = []
        for _ in range(args.bench):
            s = time.perf_counter()
            yy = fn(xd).cpu()
            lat.append(time.perf_counter() - s)
            if yy.shape != y.shape:
                raise Fatal("bench: output size drift")
        lat.sort()
        median, best = lat[len(lat) // 2], lat[0]
        log(f"bench: {args.bench} execs, median {median:.4f} s "
            f"({imgs / median:.0f} img/s), best {best:.4f} s "
            f"({imgs / best:.0f} img/s)")
        print(json.dumps({"native_serve_img_per_s_median": imgs / median,
                          "img_per_s_best": imgs / best, "median_s": median,
                          "best_s": best, "batch": imgs,
                          "execs": args.bench}), flush=True)

    if args.output:
        if not write_npy(args.output, y):
            raise Fatal(f"failed to write {args.output}")
        log(f"wrote {args.output}")

    if args.serve or args.listen:
        watchdog.off.set()  # the deadline covers the startup only
        del xd
        if args.serve:
            serve_stdin(fn, dev, x)
        else:
            serve_socket(fn, dev, args.listen, x, y,
                         bool(meta.get("rowwise", False)))
    watchdog.off.set()
    log(f"done rc={rc}")
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        return run(args)
    except Fatal as e:
        print(f"serve: FATAL: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
