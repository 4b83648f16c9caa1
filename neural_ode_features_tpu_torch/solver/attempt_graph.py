"""The ``'while'`` attempt loop of ``runge_kutta.adaptive_odeint`` on the
card: one attempt captured as a CUDA graph and replayed, in place of the
host loop's some fifty launches from Python per attempt (the counterpart of
the JAX solve's ``lax.while_loop``, which never leaves the device).

The route (``runge_kutta._while_loop`` decides it from the arguments and the
first attempt's carry, never from a failure): a CUDA state, ``unroll=
'while'``, no norm across ranks (``batch_sum``: a gloo or NCCL sum is not
captured here), and no autograd recording the attempts.  Then:

  * the first attempt runs eagerly, as on the host loop: it is the warm-up
    (the allocator, the kernels' ``cudaFuncSetAttribute``, library loads);
  * the carry is copied into static buffers and one attempt is captured
    over them on a side stream, its results written back into them (the
    dense output in place, ``torch.where(..., out=)``); the capture runs in
    ``"thread_local"`` error mode, so that another thread's allocations and
    copies (the serving host's I/O thread) cannot break it;
  * each further attempt is one replay on the caller's stream followed by
    one read of ``done.all()``, the only host read left;
  * the graph is released at the end of the solve, unless it is cached.

Memory.  A capture's intermediates live in a graph memory pool.  One pool
per device and thread (with one side stream) serves every capture of that
thread, and stays: it holds the peak intermediates of one attempt of the
largest solve the thread has run (PERF.md gives its bytes).  A pool per
solve, given back at its end, would cost each solve the allocation and the
release of that memory, several ms on the card (``chip_smoke.py``
``[graph]`` times both).

The cache.  A caller whose weights stay fixed across solves (the inference
solves of ``models.odenet_solve``: ``entry``'s and ``extract_entry``'s
``fwd``, the serving host, the sweep, extraction) passes a key
(:func:`cache_key`: the weights by address and version counter, the
configuration, the carry's shapes and dtype, the tolerances and ``ts`` by
value).  The first solve of a key runs its first attempt eagerly, captures
the next into a new entry with a memory pool of its own, and keeps it; every
later solve of the key copies its initial carry into the entry's static
buffers and replays every attempt, the first included.  A replay reads the
tensors that the capturing solve made (the laid-out weights, the tolerance
rows, the tableau's scalars, ``ts``): the entry holds them, and holds the
key's tensors so that no other tensor takes their addresses.  Any change of
the key (an in-place weight update moves the version counter) captures
anew: a stale replay is never made.  Each thread keeps at most
:data:`CACHE_ENTRIES` entries per device, the oldest evicted: the new
entry's capture takes the evicted entry's pool, whose graph is reset only
after that, so a run of misses reuses the pools' memory and the cache
holds at most :data:`CACHE_ENTRIES` pools (PyTorch would keep a pool whose
last graph is reset reserved until ``torch.cuda.empty_cache()``).  The
train step, whose weights change every step, captures per solve.

A failed capture raises; nothing falls back to the host loop.

Launch counts.  The kernel wrappers count launches in Python ints, which a
capture bumps although nothing ran, and a replay does not bump.  So the
counts the capture added are taken away, the captured graph's kernel nodes
are counted by kernel name (through the CUDA driver; a bf16 build, counted
apart, by its precision template argument too), and each replay adds those
node counts.  Where a wrapper's calls and its kernel's nodes differ
(a launch went to another stream and ran outside the graph), the capture
raises.  The same kernels run in the same order on the same buffers as on
the host loop, so the results are bit-identical to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import re
import threading

import torch

__all__ = ["replay_attempts", "kernel_nodes", "kernel_launches", "cache_key",
           "replay_cached", "capture_cached", "clear_cache", "cache_info",
           "CACHE_ENTRIES"]

_local = threading.local()


def _kernel_wrappers() -> tuple:
    """The launch counters the route keeps, as ``(wrapper, attribute,
    kernels)``: ``kernels`` maps the name in the CUDA sources of each
    kernel of which one counted launch runs one (the backward's per-sample
    pass is one of two kernels, ``kernels.odefunc_bwd.sample_pass``, or
    the bf16 build's rows backward, whose last per-sample kernel,
    ``rows_bwd_dh_kernel``, stands for the call; the
    bf16 ``odefunc``'s rows build launches seven kernels a call, of which
    its last, ``rows_gn_out_kernel``, stands for the call) to
    the build it counts, where the kernel is built for several: its
    precision template argument (``kF32``, ``kBf16Conv``, ``kBf16`` = 0,
    1, 2 in ``csrc/odefunc_common.cuh``), else None."""
    from ..kernels.conv3x3 import conv3x3
    from ..kernels.odefunc import odefunc
    from ..kernels.odefunc_bwd import odefunc_bwd
    from ..kernels.rk_step import dopri5_step

    return ((odefunc, "launches", {"odefunc_kernel": 0}),
            (odefunc, "launches_bf16", {"odefunc_kernel": 2,
                                        "rows_gn_out_kernel": None}),
            (odefunc_bwd, "launches", {"bwd_sample_kernel": 0,
                                       "bwd_sample_kernel_cluster": 0}),
            (odefunc_bwd, "launches_bf16", {"bwd_sample_kernel": 2,
                                            "bwd_sample_kernel_cluster": 2,
                                            "rows_bwd_dh_kernel": None}),
            (dopri5_step, "launches", {"rk_step_kernel": 0}),
            (dopri5_step, "launches_bf16", {"rk_step_kernel": 1}),
            (conv3x3, "launches", dict.fromkeys(
                ("tap9_kernel", "im2col_kernel", "mma_kernel", "wgmma_kernel",
                 "im2col_wgmma_kernel"))))


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@functools.cache
def _driver() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def _cu(name: str, *args) -> None:
    code = getattr(_driver(), name)(*args)
    if code:
        raise RuntimeError(f"{name} failed (CUresult {code})")


@functools.cache
def _name(func: int, kern: int) -> str:
    """A kernel's (mangled) name from its ``CUfunction`` or ``CUkernel``."""
    name = ctypes.c_char_p()
    if func:
        _cu("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(func))
    else:
        _cu("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(kern))
    return name.value.decode()


def kernel_launches(raw_graph: int) -> list:
    """The kernel nodes of a CUDA graph (``CUDAGraph.raw_cuda_graph()``)
    in the driver's order, each ``(name, grid, block, shared)``: the kernel's
    name as the driver gives it (mangled), its grid and block dimensions and
    its dynamic shared memory in bytes."""
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _cu("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    launches = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        _cu("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        _cu("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
            ctypes.byref(p))
        launches.append((_name(p.func or 0, p.kern or 0), tuple(p.grid),
                         tuple(p.block), p.shared_mem_bytes))
    return launches


def kernel_nodes(raw_graph: int) -> collections.Counter:
    """The kernel nodes of a CUDA graph (``CUDAGraph.raw_cuda_graph()``),
    counted by kernel name as the driver gives it (mangled)."""
    return collections.Counter(name for name, *_ in
                               kernel_launches(raw_graph))


def _count(nodes: collections.Counter, kernels: dict) -> int:
    """Of ``nodes``, those of the kernels named (``odefunc_kernel`` is
    mangled as ``...14odefunc_kernel...``), each of its build where that is
    not None: the last template argument, mangled ``Li<build>EE``."""
    def of_build(name, build):
        m = re.search(r"Li(\d+)EE", name)
        return build is None or (m is not None and int(m.group(1)) == build)
    return sum(c for name, c in nodes.items()
               if any((name == k or f"{len(k)}{k}" in name)
                      and of_build(name, build)
                      for k, build in kernels.items()))


def _stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's capture stream on ``device``."""
    streams = _local.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _pool(device: torch.device):
    """This thread's graph memory pool on ``device`` (the current device).
    A small graph captured into it once, and kept, keeps the pool alive
    between solves (PyTorch's device and pinned-host allocators both drop a
    pool when its last graph is reset)."""
    pools = _local.__dict__.setdefault("pools", {})
    if device not in pools:
        handle = torch.cuda.graph_pool_handle()
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.stream(_stream(device)):
            keeper.capture_begin(pool=handle,
                                 capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keeper.capture_end()
        pools[device] = (handle, keeper)
    return pools[device][0]


def _end_allocation(device: torch.device, pool) -> None:
    """Route the capture stream's allocations back to the caching allocator
    after a capture that failed: ``capture_end`` skips that step when the
    capture was invalidated (a private entry point, under either of its
    names; the card test that plants a failed capture pins it)."""
    end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
           or torch._C._cuda_endAllocateCurrentStreamToPool)
    try:
        end(device.index, pool)
    except RuntimeError:  # ``capture_end`` did it
        pass


def _capture(graph, body, static, stream, pool) -> None:
    """Capture ``body`` over the ``static`` carry into ``graph`` on
    ``stream``, its intermediates in ``pool``, its results copied back into
    ``static``.  A failure ends the capture and raises."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            new = body(static)
            for buf, val in zip(static, new):
                if val is not buf:
                    buf.copy_(val)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:  # the capture was invalidated
                pass
            _end_allocation(stream.device, pool)
            raise
        graph.capture_end()


def _captured(body, carry, pool):
    """Capture one attempt of ``body`` over a copy of ``carry`` (its static
    buffers) into a new graph, its intermediates in ``pool``.  Returns
    ``(graph, static, per_replay)``, ``per_replay`` the launches of each
    counted wrapper that one replay makes (the graph's kernel nodes).  The
    counters are left as they were: a capture launches nothing."""
    device = carry.done.device
    wrappers = _kernel_wrappers()
    static = type(carry)(*(x.clone() for x in carry))
    side = _stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = [getattr(w, a) for w, a, _ in wrappers]
    try:
        try:
            _capture(graph, body, static, side, pool)
        finally:  # a capture launches nothing
            issued = [getattr(w, a) - b
                      for (w, a, _), b in zip(wrappers, before)]
            for (w, a, _), b in zip(wrappers, before):
                setattr(w, a, b)
        nodes = kernel_nodes(graph.raw_cuda_graph())
        per_replay = [_count(nodes, names) for _, _, names in wrappers]
        if per_replay != issued:
            raise RuntimeError(
                f"the captured attempt holds {per_replay} launches of "
                f"{[f'{w.__name__}.{a}' for w, a, _ in wrappers]}, their "
                f"wrappers issued {issued}: a launch ran outside the graph")
        graph.instantiate()
    except BaseException:
        graph.reset()
        raise
    return graph, static, per_replay


def _replay(graph, static, per_replay, steps: int) -> None:
    """Up to ``steps`` replays, one read of ``done.all()`` after each."""
    wrappers = _kernel_wrappers()
    for _ in range(steps):
        graph.replay()
        for (w, a, _), n in zip(wrappers, per_replay):
            setattr(w, a, getattr(w, a) + n)
        if bool(static.done.all()):
            break


def replay_attempts(body, carry, steps: int):
    """Up to ``steps`` further attempts of ``body`` (``carry -> carry``,
    writing the dense output into its input's buffer) from ``carry``: one
    capture, then one replay per attempt until every row is done.  Returns
    the final carry (the static buffers)."""
    if steps < 1 or bool(carry.done.all()):
        return carry
    device = carry.done.device
    with torch.cuda.device(device):
        pool = _pool(device)
        try:
            graph, static, per_replay = _captured(body, carry, pool)
        except BaseException:
            # The allocator may still count the failed graph as a user of
            # the pool: this thread's next capture takes a new one.
            _local.pools.pop(device, None)
            raise
        try:
            _replay(graph, static, per_replay, steps)
        finally:
            graph.reset()
    return static


# -- the cache: one captured attempt per shape for fixed-weight callers ------

CACHE_ENTRIES = 4


class _Entry:
    """A captured attempt kept across solves: the instantiated graph, its
    static carry, the launches one replay makes, its own memory pool, and
    what its replays read that the solve which captured it made (``body``:
    the closure over the laid-out weights, tolerance rows, tableau scalars,
    ``ts``; ``keep``: the key's tensors, held so that no other tensor can
    take their addresses)."""

    __slots__ = ("graph", "static", "per_replay", "pool", "body", "keep",
                 "replays")

    def __init__(self, graph, static, per_replay, pool, body, keep):
        self.graph, self.static, self.per_replay = graph, static, per_replay
        self.pool, self.body, self.keep = pool, body, keep
        self.replays = 0


def _entries(device: torch.device) -> collections.OrderedDict:
    """This thread's cache on ``device``, oldest entry first."""
    caches = _local.__dict__.setdefault("caches", {})
    return caches.setdefault(device, collections.OrderedDict())


def cache_key(parts) -> tuple:
    """``(key, keep)``: ``parts`` (nested tuples of hashables and tensors)
    with each tensor replaced by its address, version counter, shape,
    strides, dtype and device; ``keep``, those tensors.  An in-place write
    to a tensor bumps its version (a write through ``.data`` does not, and
    is not seen)."""
    keep = []

    def norm(x):
        if isinstance(x, torch.Tensor):
            keep.append(x)
            return ("tensor", x.data_ptr(), x._version, tuple(x.shape),
                    x.stride(), x.dtype, x.device)
        if isinstance(x, (tuple, list)):
            return tuple(norm(v) for v in x)
        return x

    return norm(parts), keep


def replay_cached(carry, steps: int, key):
    """Up to ``steps`` attempts from ``carry``, every one a replay of this
    thread's entry for ``key`` (the first included), after copying
    ``carry`` into its static buffers; None where there is no entry."""
    device = carry.done.device
    entries = _entries(device)
    entry = entries.get(key)
    if entry is None:
        return None
    entries.move_to_end(key)
    with torch.cuda.device(device):
        for buf, x in zip(entry.static, carry):
            buf.copy_(x)
        _replay(entry.graph, entry.static, entry.per_replay, steps)
        entry.replays += 1
    return _copied(entry.static)


def capture_cached(body, carry, steps: int, key, keep):
    """A miss, after the eager first attempt: capture an attempt into a new
    entry for ``key``, then up to ``steps`` replays.  Below
    :data:`CACHE_ENTRIES` entries the capture takes a new pool; at the bound
    it evicts the oldest entry and takes its pool."""
    if steps < 1 or bool(carry.done.all()):
        return carry
    device = carry.done.device
    entries = _entries(device)
    with torch.cuda.device(device):
        evicted = None
        if len(entries) >= CACHE_ENTRIES:
            evicted = entries.popitem(last=False)[1]
            pool = evicted.pool
            # Its buffers go; its graph keeps the pool until the new one
            # holds it.
            evicted.static = evicted.body = evicted.keep = None
        else:
            pool = torch.cuda.graph_pool_handle()
        try:
            graph, static, per_replay = _captured(body, carry, pool)
        finally:
            if evicted is not None:
                evicted.graph.reset()
        entries[key] = _Entry(graph, static, per_replay, pool, body, keep)
        _replay(graph, static, per_replay, steps)
    return _copied(static)


def _copied(static):
    """A copy of an entry's static carry: the next replay of the entry does
    not change what a solve returned."""
    return type(static)(*(x.clone() for x in static))


def clear_cache() -> None:
    """Drop this thread's captured attempts (every device)."""
    for entries in _local.__dict__.get("caches", {}).values():
        while entries:
            entries.popitem(last=False)[1].graph.reset()


def cache_info(device=None) -> list[dict]:
    """This thread's entries on ``device`` (default: the current one),
    oldest first: the solves each served by replay alone, and the bytes of
    its pool (the segments the caching allocator keeps for it)."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    entries = _entries(device)
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", ()))
        pools[pid] = pools.get(pid, 0) + seg["total_size"]
    return [{"replayed_solves": e.replays,
             "pool_bytes": pools.get(tuple(e.pool), 0),
             "batch": int(e.static.done.shape[0])}
            for e in entries.values()]
