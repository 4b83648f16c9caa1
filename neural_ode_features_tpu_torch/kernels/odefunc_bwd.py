"""Fused ODEfunc backward kernel: the VJP of f(t, h), giving (dθ, dt, dh).

Replaces the TPU kernel ``neural_ode_features_tpu/kernels/odefunc_bwd_rows.py``
(``odefunc_bwd_rows`` → ``_bwd_rows_kernel``).  Source:
``csrc/odefunc_bwd.cu`` (with the per-sample forward helpers of
``csrc/odefunc_common.cuh``).

The kernel recomputes the forward from ``(params, t, h)``, as the TPU kernel
does, so the residuals of the VJP are only those three; it also writes the
recomputed f(t, h) (``with_f=True``), so that an augmented evaluation of the
adjoint is this one call and no launch of the ODEfunc kernel.  The TPU kernel
summed the parameter gradients over the batch by read-modify-write into
revisited output blocks, race-free only because a TPU grid runs in order.
Here a per-sample pass writes dh, dt and per-sample partial sums, and two
more launches reduce over the batch in a fixed order: no atomics, and two
calls on the same inputs give bit-identical dθ.  The per-sample pass
(:func:`sample_pass`) is one CTA of 512 threads per sample, or, for both
builds at C = 64 (7×7×64, 6×6×64: the ``wgmma3`` and ``wgmma_bf16``
shapes) with an even group count, a cluster of two CTAs of 256 threads per
sample (``bwd_sample_kernel_cluster``): each CTA owns 32 output channels,
so no GroupNorm group is split, keeps its half of the state, and writes
every conv input into its peer's shared memory too (Hopper's distributed
shared memory); its four convs run ``wgmma.mma_async`` (3×TF32, or one
bf16 pass in the bf16 build) on its output half, the input-gradient convs
from tap 8 − k's weights transposed.  In the f32 build both passes give
the same bits.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 495 TFLOP/s TF32 on them, 3.35 TB/s): six 3×3-conv equivalents
(forward recompute, input gradients, weight gradients), 21.7 MFLOP per
sample at 7×7×64, 2.77 GFLOP at B = 128: about 41 µs of FFMA, 5.6 µs of TF32
products; the bytes are about 6.4 MB, 1.9 µs.  So it is bound by operations.
The per-sample pass runs its four convs (two of the forward, two input
gradients) on the tensor cores at C = 64 to 512 (multiples of 32) on 7×7
and 6×6 maps, 3×TF32, f32-grade: the recompute's two on the forward
kernels' stage (``kernels.odefunc.stage``: ``wgmma3`` at the widths of
``WGMMA_C``, so that f is the ODEfunc kernel's bit for bit), the
input-gradient convs on ``mma.sync`` (``'mma3'``; the cluster pass: on
``wgmma``, with the same bits), reading ``w1``, ``w2`` themselves, taps
reversed and transposed.  The conv1
output u stays in shared memory where it fits; from 7×7×256 it goes to a
global scratch beside r1 and r2 (:func:`u_global`), and from 7×7×288 the
state x to the dh output (``kernels.odefunc.layout``).  The weight-gradient
contraction runs on the tensor cores at every shape: per (conv, tap) a
GEMM over the B·H·W rows of the saved activations r1, r2 and cotangents gu,
gv, 3×TF32 (one exact pass in bf16), each 32-row step of a sample summed
from zero, the steps of 8 samples added in f32, then those group sums.
Where C % 64 == 0 (:func:`weight_kernel`) it is ``bwd_weight_kernel``,
chains of ``wgmma.mma_async.m64n64k8`` TF32 with B (g's rows, staged
transposed) from shared memory: a CTA of three warpgroups, one tap each of
a row of three, on a 64×64 tile; elsewhere (C = 32, C % 64 == 32)
``bwd_weight_kernel_mma`` (``mma.sync``), which the readings of
``probes/timing_aids.py`` also run at every shape: both sum every output in
the same order, so they give the same bits.  The rows are cut into
:func:`weight_splits` chunks, summed by the
reduction in order; its scratch is (splits, 2, 9, C, C), 19 MB at C = 512
and B = 128.  :func:`weight_grad_emulated` repeats that arithmetic in plain
PyTorch (tests only).

At the bf16 build's wide shapes (C = 96 to 512 on 7×7 and 6×6 maps,
:func:`sample_pass` ``'rows'``) the per-sample pass is the rows backward:
a fixed sequence of launches on the current stream, each of its four
convs (the recompute's two, the two input gradients, whose packing reads
tap 8 − k's weights transposed) one bf16 ``wgmma`` GEMM over the rows of
every sample (``csrc/rows_conv.cuh``), the GroupNorms, ReLU masks,
per-sample partials and dt in five GroupNorm launches between them, each
splitting a sample over ``kernels.odefunc.rows_slices`` CTAs, a slice of
whole groups each, that hold the one-CTA pass's (pixel group, channel)
slots for their channels and add in its order (dt's sum over the channels
gathered from the slices' per-channel sums in channel order), so that
every output is that pass's bit for bit; that pass stays readable as
``probes/timing_aids.py`` ``odefunc_bwd_cta_bf16``.  Its scratch (:func:`rows_bwd_scratch_bytes`,
and u) comes from the caching allocator on the current stream, so that a
captured call (the adjoint's graph route) captures it too.

``precision='bf16'`` runs the kernel's bf16 build (``odefunc_backward_bf16``):
the VJP of the ``compute_dtype='bfloat16'`` dynamics (the ODEfunc kernel's
bf16 build, ``odefunc_plain(..., 'bf16')``), whose JAX counterpart is
``jax.vjp`` of the jnp bf16 dynamics (the TPU kernel computes in f32 only).
It recomputes the forward as that build does (its f is the bf16 forward's
bit for bit) and rounds where autograd through the plain bf16 f rounds: the
cotangent on entry; in each GroupNorm the per-element ``dy·scale`` and
``dy·bf16(x̂)``, its f32 statistics backward, dx on leaving; each
input-gradient conv's sum (bf16 operands on the tensor cores,
``mma.sync.m16n8k16`` with f32 accumulation, the taps reversed and
transposed in the fragment loads; in the cluster pass ``wgmma`` bf16; f32
FFMA on rounded weights at the FFMA shapes); the time-map products.  Each sum over the batch (weight, scale and
bias gradients) is kept in f32 per sample, reduced in the fixed order and
rounded once, as the plain path rounds it once (the weight gradients: r1,
r2, gu, gv hold bf16 values, which one TF32 pass of the tensor cores
multiplies exactly); the time column, which the plain path sums in f32
from per-pixel bf16 values, is not rounded.  f, dh,
dt and every leaf but the time column hold bf16 values.  Bound at B = 128,
7×7×64: 2.77 GFLOP at 989 TFLOP/s dense bf16, 2.8 µs, against 1.9 µs of
bytes: bound by operations (0.0414 ms on the CUDA cores in f32).

``odefunc_bwd`` is the wrapper: a CPU tensor takes the plain PyTorch version
``odefunc_bwd_plain`` (``torch.autograd.grad`` of ``odefunc_plain`` at the
same precision); a CUDA tensor launches the kernel or raises.
``odefunc_bwd.launches`` counts the f32 build's launches,
``odefunc_bwd.launches_bf16`` the bf16 build's.  Both return the parameter
gradients in the raw ODEfunc layout (conv kernels (3, 3, C+1, C), time
channel first): the time column is the tap-validity contraction of the time
map's cotangent (:func:`tap_contract`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .odefunc import (
    MAX_SMEM,
    MMA_C,
    MMA_M,
    PAD_A,
    THREADS,
    OdefuncWeights,
    bf16_round,
    check_cuda_inputs,
    layout,
    odefunc_plain,
    prepare,
    ptr,
    refusal,
    rows_scratch_bytes,
    rows_slices,
    stage,
    stream,
    supported,
    weight_pointers,
)

__all__ = ["odefunc_bwd", "odefunc_bwd_plain", "bwd_supported",
           "bwd_refusal", "bwd_smem_bytes", "u_global", "tap_contract",
           "sample_pass", "cluster_smem_bytes", "pair_area_floats",
           "PAIR_THREADS", "PAIR_C",
           "weight_splits", "weight_smem_bytes", "weight_kernel",
           "wgmma_weights_ok",
           "mma_weight_smem_bytes", "wgmma_weight_smem_bytes",
           "bwd_residuals_plain",
           "weight_grad_emulated", "weight_grad_f64", "rows_bwd_smem_bytes",
           "rows_bwd_scratch_bytes", "rows_bwd_slice_smem_bytes"]

# Mirror csrc/odefunc_bwd.cu (kParts, kStepRows, kGroupSamples, kWeightPad,
# weight_tile, weight_taps_of; the wgmma weight kernel's kWgThreads,
# kWgMaxRows).
_PARTS = 26
_STEP_ROWS = 32
_GROUP_SAMPLES = 8
_WEIGHT_PAD = 8
_WG_THREADS = 384
_WG_MAX_ROWS = 3 * _WG_THREADS // 16
# The cluster pass (kPairThreads, kPairC): threads per CTA, channels a CTA
# owns.
PAIR_THREADS = 256
PAIR_C = 32
# The split count's search (weight_splits): the CTAs it aims to keep busy
# (the SMs), the most row chunks, and splits × C² at most (wpart ≤ 151 MB).
_WEIGHT_SLOTS = 132
_MAX_SPLIT = 64
_MAX_SPLIT_FLOATS = 8 * 512 * 512


def _weight_tile(c: int) -> int:
    """The ``mma.sync`` weight kernel's tile (csrc ``weight_tile``)."""
    return 64 if c % 64 == 0 else 32


def _weight_taps(c: int) -> int:
    """The ``mma.sync`` weight kernel's taps a CTA (``weight_taps_of``)."""
    return 3 if _weight_tile(c) == 64 else 9


def weight_splits(b: int, c: int) -> int:
    """Row chunks of the weight-gradient kernels at batch ``b`` and width
    ``c``: of 1 to min(b, 64, 8·512²/c²), the count that minimises waves ×
    (samples per CTA + 1), a wave being 132 CTAs (the +1: a CTA's first
    copy and its stores), the smallest of equals, over the grid of the
    ``mma.sync`` kernel (``bwd_weight_kernel_mma``: 64×64 tiles of three
    taps, or 32×32 of nine where C % 64 == 32).  22 at B = 128, C = 64
    (132 CTAs); 1 at C = 512.  The ``wgmma`` kernel (``bwd_weight_kernel``,
    C ≥ 64: 64×64 tiles of three taps, the last tile zero-filled where
    C % 64 == 32) takes the same count, so both kernels sum every output in
    the same order; its grid is not an input of the search.  The one home
    of the count: the wrapper passes it to the kernel (which takes any
    count from 1 to B) and sizes the scratch ``wpart`` (splits, 2, 9, C, C)
    by it, which so never exceeds the 151 MB of the FFMA kernel's fixed 8
    chunks at C = 512.  It depends on (b, c) alone, so a shape's order of
    sums is fixed."""
    t = _weight_tile(c)
    base = 2 * (9 // _weight_taps(c)) * (c // t) ** 2
    best, best_cost = 1, None
    for ns in range(1, min(b, _MAX_SPLIT, _MAX_SPLIT_FLOATS // (c * c)) + 1):
        cost = -(-base * ns // _WEIGHT_SLOTS) * (-(-b // ns) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = ns, cost
    return best


def wgmma_weights_ok(hw: tuple[int, int], c: int) -> bool:
    """Whether ``bwd_weight_kernel`` (``wgmma``) can run at this shape
    (csrc/odefunc_bwd.cu ``wgmma_weights_ok``): C ≥ 64, a sample's H·W
    rows, padded to a multiple of 8, at most 72, and its staging
    (:func:`wgmma_weight_smem_bytes`) within shared memory: every map the
    forward takes at C ≥ 64."""
    hh, ww = hw
    nk = -(-hh * ww // 8) * 8
    return (c >= 64 and nk <= _WG_MAX_ROWS
            and wgmma_weight_smem_bytes(hw, c) <= MAX_SMEM)


def weight_kernel(hw: tuple[int, int], c: int) -> str:
    """Which weight-gradient kernel the backward runs at this shape
    (csrc/odefunc_bwd.cu ``wgmma_weights``): ``'wgmma'``
    (``bwd_weight_kernel``, ``wgmma.mma_async`` TF32) where C % 64 == 0 and
    :func:`wgmma_weights_ok`; else ``'mma'`` (``bwd_weight_kernel_mma``,
    ``mma.sync``: C = 32, and C % 64 == 32, where its 32×32 tiles of nine
    taps were the faster, PERF.md)."""
    return "wgmma" if c % 64 == 0 and wgmma_weights_ok(hw, c) else "mma"


def mma_weight_smem_bytes(hw: tuple[int, int], c: int) -> int:
    """Dynamic shared memory of the ``mma.sync`` weight kernel
    (csrc/odefunc_bwd.cu ``mma_weight_smem_bytes``): two buffers, each a
    sample's bordered r map and its g rows (H·W padded to a multiple of 8),
    each row T + 8 floats; then 32 group sums per thread and one int per g
    row."""
    hh, ww = hw
    nk = -(-hh * ww // 8) * 8
    t = _weight_tile(c)
    warps = _weight_taps(c) * (t // 32) ** 2
    return (4 * (2 * ((hh + 2) * (ww + 2) + nk) * (t + _WEIGHT_PAD)
                 + 32 * 32 * warps) + 4 * nk)


def wgmma_weight_smem_bytes(hw: tuple[int, int], c: int,
                            exact: bool = False) -> int:
    """Dynamic shared memory of the ``wgmma`` weight kernel
    (csrc/odefunc_bwd.cu ``wgmma_weight_smem_bytes``; ``exact``: the bf16
    build, one transposed g tile): two buffers, each a sample's bordered r
    map, 64 + 8 floats a row, and g's rows transposed, a tile of
    8·(8·nk + 4) floats (nk = H·W padded to a multiple of 8), two (head and
    tail) in 3×TF32; then 32 group sums per thread of 384 and one int per
    g row.  153,888 bytes at 7×7 in f32, 124,960 in bf16."""
    hh, ww = hw
    nk = -(-hh * ww // 8) * 8
    gt = (1 if exact else 2) * 8 * (8 * nk + 4)
    return (4 * (2 * ((hh + 2) * (ww + 2) * (64 + _WEIGHT_PAD) + gt)
                 + 32 * _WG_THREADS) + 4 * nk)


def weight_smem_bytes(hw: tuple[int, int], c: int) -> int:
    """Dynamic shared memory of the weight-gradient kernel that runs at
    this shape (csrc/odefunc_bwd.cu ``weight_smem_bytes``): the ``wgmma``
    kernel's 3×TF32 build where :func:`weight_kernel` gives ``'wgmma'``,
    else the ``mma.sync`` kernel's."""
    if weight_kernel(hw, c) == "wgmma":
        return wgmma_weight_smem_bytes(hw, c)
    return mma_weight_smem_bytes(hw, c)


def u_global(hw: tuple[int, int], c: int, groups: int) -> bool:
    """Whether the per-sample pass keeps the conv1 output u (H·W·C floats)
    in global scratch in place of shared memory (csrc/odefunc_bwd.cu
    ``bwd_shape``): on the wide tensor-core stage where u does not fit
    beside the forward's working set, on 7×7 maps from C = 256."""
    return layout(hw, c, groups, backward=True).u_global


def bwd_smem_bytes(hw: tuple[int, int], c: int, groups: int) -> int:
    """Dynamic shared memory per CTA of the one-CTA-per-sample pass
    (csrc/odefunc_bwd.cu ``bwd_smem_bytes``; either build's outside
    :func:`sample_pass`'s cluster gate): the forward's, 6·G
    statistics, 4·C channel sums and, unless :func:`u_global`, u."""
    return layout(hw, c, groups, backward=True).smem


def sample_pass(hw: tuple[int, int], c: int, groups: int,
                precision: str = "f32") -> str:
    """Which per-sample pass the backward's build of ``precision``
    (``'f32'`` or ``'bf16'``) runs, by the shape alone (csrc/odefunc_bwd.cu
    ``pair_ok``, ``rows_bwd_ok``): ``'cluster'``, two CTAs of 256 threads
    per sample, each owning 32 output channels, at the ``wgmma`` shapes
    (C = 64: 7×7×64, 6×6×64; ``wgmma3`` in f32, ``wgmma_bf16`` in bf16)
    where the group count is even, so that no GroupNorm group has channels
    in both halves; ``'rows'``, the rows backward, for the bf16 build at
    the bf16 dynamics' rows-build shapes (``stage`` ``'rows_bf16'``: C = 96
    to 512 on 7×7 and 6×6 maps) that the backward takes, where a sample's
    bordered map fits (:func:`rows_bwd_smem_bytes`); else ``'cta'``, one
    CTA of 512 threads per sample."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    if (stage(hw, c, precision) in ("wgmma3", "wgmma_bf16") and groups > 0
            and c % groups == 0 and groups % 2 == 0):
        return "cluster"
    if (precision == "bf16" and stage(hw, c, "bf16") == "rows_bf16"
            and supported(hw, c, groups) and bwd_supported(hw, c, groups)
            and rows_bwd_smem_bytes(hw, c, groups) <= MAX_SMEM):
        return "rows"
    return "cta"


def rows_bwd_smem_bytes(hw: tuple[int, int], c: int, groups: int) -> int:
    """The rows backward gate's clause on shared memory (csrc/odefunc_bwd.cu
    ``rows_bwd_smem_bytes``): a sample's bordered cotangent map,
    (H+2)·(W+2)·C floats, 2·512 partial sums, 2·G statistics and 4·C
    channel sums within one CTA, as the one-CTA per-sample launches that
    first ran the rows backward held them; the sliced launches take far
    less (:func:`rows_bwd_slice_smem_bytes`), and the clause keeps the set
    of shapes.  178,432 bytes at 7×7×512."""
    hh, ww = hw
    return 4 * ((hh + 2) * (ww + 2) * c + 2 * THREADS + 2 * groups + 4 * c)


def rows_bwd_scratch_bytes(b: int, hw: tuple[int, int], c: int,
                           groups: int) -> int:
    """Bytes of the rows backward's scratch beside u (csrc/odefunc_bwd.cu
    ``rows_bwd_scratch_bytes``): the rows conv's (the bf16 conv input of the
    batch, one conv's packed weights, reused by the four convs in turn,
    ``kernels.odefunc.rows_scratch_bytes``), then GN1's and GN2's
    statistics, (B, 2, 2, G) floats, then the t gradient's per-channel
    sums of conv2 and conv1, (B, 2, C) floats."""
    return rows_scratch_bytes(b, hw, c, True) + 4 * 4 * b * groups + 4 * 2 * b * c


def rows_bwd_slice_smem_bytes(hw: tuple[int, int], c: int,
                              groups: int) -> int:
    """Dynamic shared memory of the rows backward's sliced GroupNorm
    backwards (csrc/odefunc_bwd.cu ``rows_bwd_slice_smem_bytes``): two
    staged slices (the GroupNorm input and the cotangent, H·W·C/slices
    floats each, ``kernels.odefunc.rows_slices``), four partial sums a
    thread, four floats a group of the slice (mean, inv, two group means),
    two a channel of the slice, and a conv's C per-channel t sums (dt's
    gather).  55,424 bytes at 7×7×512 with 32 groups."""
    n = rows_slices(groups)
    return 4 * (2 * hw[0] * hw[1] * (c // n) + 4 * (THREADS // n)
                + 4 * (groups // n) + 2 * (c // n) + c)


def cluster_smem_bytes(hw: tuple[int, int], c: int, groups: int,
                       precision: str = "f32") -> int:
    """Dynamic shared memory per CTA of the cluster pass of the build of
    ``precision`` (csrc/odefunc_bwd.cu ``pair_smem_bytes``): its weight area
    (:func:`pair_area_floats`), the whole conv input with its zero border
    (the tensor-core stage's rows and pitch), its halves of x and u (H·W·32
    each), 2·256 partial sums, 3·G statistics (its G/2 groups), 4·32
    channel sums and 2·C t-gradient sums.  72,976 bytes at 7×7×64 and
    69,072 at 6×6×64; the bf16 build 60,688 and 56,784."""
    hh, ww = hw
    rows = MMA_M + 2 * (ww + 2) + 2
    pitch = MMA_C * -(-c // MMA_C) + PAD_A
    return 4 * (pair_area_floats(precision) + rows * pitch
                + 2 * hh * ww * PAIR_C + 2 * PAIR_THREADS + 3 * groups
                + 4 * PAIR_C + 2 * c)


def pair_area_floats(precision: str = "f32") -> int:
    """Floats of a cluster CTA's weight area (csrc/odefunc_bwd.cu
    ``pair_area_floats``): its operand tiles, the TF32 heads and tails of
    its half of a tap's weights (2·32·64 floats) in f32 or its bf16 tile
    (32·64 bf16, 1,024 floats) in bf16, then the f32 tile as copied (64·64)
    and its two mbarriers (4)."""
    tiles = 2 * PAIR_C * MMA_C if precision == "f32" else PAIR_C * MMA_C // 2
    return tiles + MMA_C * MMA_C + 4


def bwd_refusal(hw: tuple[int, int], c: int, groups: int) -> str | None:
    """Why the backward kernel does not take this shape, or None: the
    forward kernels' gate under the backward's layout (``layout(...,
    backward=True)``), C at least 32 and a multiple of the weight-gradient
    tile (64, or 32 where C % 64 == 32).  On 7×7 and 6×6 maps with groups
    32 every multiple of 32 up to 512 passes."""
    why = refusal(hw, c, groups)
    if why is not None:
        return why
    if c < 32 or c % _weight_tile(c):
        return "C >= 32, a multiple of 32"
    if bwd_smem_bytes(hw, c, groups) > MAX_SMEM:
        return (f"the per-sample working set ({bwd_smem_bytes(hw, c, groups)}"
                f" B) exceeds the {MAX_SMEM} B of shared memory")
    if weight_smem_bytes(hw, c) > MAX_SMEM:
        return (f"the weight-gradient staging ({weight_smem_bytes(hw, c)} B) "
                f"exceeds the {MAX_SMEM} B of shared memory")
    return None


def bwd_supported(hw: tuple[int, int], c: int, groups: int) -> bool:
    """The backward kernel's shape gate: :func:`bwd_refusal` finds
    nothing."""
    return bwd_refusal(hw, c, groups) is None


def tap_contract(dm: torch.Tensor, kh: int = 3, kw: int = 3,
                 padding: int = 1) -> torch.Tensor:
    """Adjoint of ``ops.layers.time_map``: the time-column kernel gradient
    (kh, kw, 1, C) from the time map's cotangent ``dm`` (H, W, C).  Tap
    (ky, kx) sums ``dm`` over the pixels where it reads inside the map
    (``mask9ᵀ · dm``), in elementwise f32."""
    hh, ww, c = dm.shape
    ones = F.pad(torch.ones((hh, ww), dtype=dm.dtype, device=dm.device),
                 (padding, padding, padding, padding))
    taps = [(ones[ky:ky + hh, kx:kx + ww, None] * dm).sum(dim=(0, 1))
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps).reshape(kh, kw, 1, c)


def _raw_grads(d: OdefuncWeights) -> dict:
    """Gradients of the kernel layout (:class:`OdefuncWeights`) in the raw
    ODEfunc layout: each conv kernel's time column from its map's cotangent."""

    def conv(dw, db, dm):
        return {"kernel": torch.cat([tap_contract(dm), dw], dim=2),
                "bias": db}

    return {
        "norm1": {"scale": d.n1s, "bias": d.n1b},
        "conv1": conv(d.w1, d.b1, d.m1),
        "norm2": {"scale": d.n2s, "bias": d.n2b},
        "conv2": conv(d.w2, d.b2, d.m2),
        "norm3": {"scale": d.n3s, "bias": d.n3b},
    }


def odefunc_bwd_plain(w: OdefuncWeights, t, h: torch.Tensor, g: torch.Tensor,
                      groups: int, with_f: bool = False,
                      precision: str = "f32"):
    """Plain PyTorch version of the kernel: ``torch.autograd.grad`` of
    ``odefunc_plain`` at ``(w, t, h)`` and ``precision`` ('f32' or 'bf16')
    against the cotangent ``g``.  Returns ``(dparams raw, dt (B,), dh)``,
    and f(t, h) as a fourth value where ``with_f``; ``dt`` is per sample
    even for a scalar ``t``, as the kernel's."""
    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    b = h.shape[0]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in w]
        tb = (torch.as_tensor(t, dtype=h.dtype, device=h.device).detach()
              .reshape(-1).expand(b).clone().requires_grad_())
        hh = h.detach().requires_grad_()
        out = odefunc_plain(OdefuncWeights(*leaves), tb, hh, groups,
                            precision)
        grads = torch.autograd.grad(out, [*leaves, tb, hh], g)
    res = (_raw_grads(OdefuncWeights(*grads[:-2])), grads[-2], grads[-1])
    return (*res, out.detach()) if with_f else res


def bwd_residuals_plain(w: OdefuncWeights, t, h: torch.Tensor,
                        g: torch.Tensor, groups: int,
                        precision: str = "f32") -> tuple[torch.Tensor, ...]:
    """What the weight gradients contract, from the plain path at
    ``precision``: ``(r1, r2, gu, gv)``, each (B, H, W, C) in float32 (bf16
    values where ``precision='bf16'``): r1 = relu(GN1(h)) and r2 =
    relu(GN2(u)), the two convs' inputs, and gu, gv, the cotangents of the
    conv outputs u and v (bias and t·M included) under ``g``, by autograd
    through the same operations as ``odefunc_plain``."""
    from ..ops.layers import conv2d, group_norm

    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    x = h.to(torch.bfloat16) if precision == "bf16" else h
    tt = torch.as_tensor(t, dtype=x.dtype, device=h.device).reshape(-1, 1, 1, 1)
    with torch.enable_grad():
        r1 = torch.relu(group_norm({"scale": w.n1s, "bias": w.n1b},
                                   x.detach(), groups=groups))
        u = (conv2d({"kernel": w.w1, "bias": w.b1}, r1, padding=1)
             + tt * w.m1.to(x.dtype)).detach().requires_grad_()
        r2 = torch.relu(group_norm({"scale": w.n2s, "bias": w.n2b}, u,
                                   groups=groups))
        v = conv2d({"kernel": w.w2, "bias": w.b2}, r2, padding=1) + (
            tt * w.m2.to(x.dtype))
        f = group_norm({"scale": w.n3s, "bias": w.n3b}, v,
                       groups=groups).to(h.dtype)
        gu, gv = torch.autograd.grad(f, [u, v], g)
    return tuple(a.detach().float() for a in (r1, r2, gu, gv))


def weight_grad_emulated(r: torch.Tensor, g: torch.Tensor,
                         precision: str = "f32",
                         splits: int | None = None) -> torch.Tensor:
    """The weight-gradient kernels' arithmetic in plain PyTorch (both
    ``bwd_weight_kernel`` on ``wgmma`` and ``bwd_weight_kernel_mma`` on
    ``mma.sync``, which sum in the same order): one conv's
    dW (3, 3, C, C) (tap, input channel, output channel, the time channel
    left out) = Σ over samples and pixels of r shifted by the tap ⊗ g, from
    float32 ``r``, ``g`` (B, H, W, C).  As the kernel: the batch cut into
    ``splits`` chunks (default :func:`weight_splits`), ``B·split/splits``
    to ``B·(split + 1)/splits``; within a chunk, sample by sample, each
    32-row step of a sample's H·W rows summed from zero and added to a
    running sum in f32, which every 8 samples (and at the chunk's end) is
    added to the chunk's total and starts again from zero; the chunks added
    in order, and in bf16 the sum rounded once.  A step's products: 'f32', 3×TF32 from
    :func:`kernels.conv3x3.tf32_split` heads and tails, ``(lo·hi + hi·lo) +
    hi·hi``; 'bf16', the products of the bf16 values themselves, exact in
    f32.  The sum within a step is a float32 matrix product, whose order is
    the library's, not the tensor core's: the emulation agrees with the
    kernel to f32 rounding of a step, not bit for bit.  For tests; nothing
    on a path calls it."""
    from .conv3x3 import tf32_split

    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    if r.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError("weight_grad_emulated takes float32 r and g")
    b, hh, ww, c = r.shape
    ns = weight_splits(b, c) if splits is None else splits
    hw = hh * ww
    rp = F.pad(r, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([rp[:, ky:ky + hh, kx:kx + ww].reshape(b, hw, c)
                        for ky in range(3) for kx in range(3)])
    gg = g.reshape(b, hw, c)

    def step(a, bb):  # (9, k, C), (k, C) -> (9, C, C)
        if precision == "bf16":
            return a.transpose(1, 2) @ bb
        a_hi, a_lo = tf32_split(a)
        b_hi, b_lo = tf32_split(bb)
        return ((a_lo.transpose(1, 2) @ b_hi + a_hi.transpose(1, 2) @ b_lo)
                + a_hi.transpose(1, 2) @ b_hi)

    total = torch.zeros((9, c, c), dtype=torch.float32, device=r.device)
    for sp in range(ns):
        chunk = torch.zeros_like(total)
        lo, hi = b * sp // ns, b * (sp + 1) // ns
        for g0 in range(lo, hi, _GROUP_SAMPLES):
            run = torch.zeros_like(total)
            for bi in range(g0, min(hi, g0 + _GROUP_SAMPLES)):
                for k0 in range(0, hw, _STEP_ROWS):
                    run = run + step(taps[:, bi, k0:k0 + _STEP_ROWS],
                                     gg[bi, k0:k0 + _STEP_ROWS])
            chunk = chunk + run
        total = total + chunk
    if precision == "bf16":
        total = bf16_round(total)
    return total.reshape(3, 3, c, c)


def weight_grad_f64(r: torch.Tensor, g: torch.Tensor,
                    absolute: bool = False) -> torch.Tensor:
    """One conv's weight-gradient contraction (3, 3, C, C) from (B, H, W, C)
    ``r``, ``g`` in float64, Σ over the rows of r shifted by the tap times
    g; ``absolute``: of |r| and |g|, the scale of the rounding of a sum of
    those products, the unit of the emulation's and the kernel's bounds
    (tests, ``chip_smoke.py``)."""
    c = r.shape[-1]
    op = torch.abs if absolute else (lambda a: a)
    rp = F.pad(op(r.double()), (0, 0, 1, 1, 1, 1))
    gg = op(g.double()).reshape(-1, c)
    hh, ww = r.shape[1:3]
    return torch.stack([rp[:, ky:ky + hh, kx:kx + ww].reshape(-1, c).T @ gg
                        for ky in range(3) for kx in range(3)]
                       ).reshape(3, 3, c, c)


# The C entry point of each build of the kernel (csrc/odefunc_bwd.cu); the
# bf16 one takes the rows backward's scratch last.  Readings for
# measurement (probes/timing_aids.py), on no path: the bf16 build on the
# per-sample passes alone (odefunc_backward_bf16_cta), each build with its
# weight gradients on the mma.sync kernel at every shape (_MMA_WEIGHTS; the
# bf16 one takes the scratch too) and the weight-gradient launch alone
# (odefunc_bwd_weight_grads).
_ENTRY = {"f32": "odefunc_backward", "bf16": "odefunc_backward_bf16"}
_CTA_BF16 = "odefunc_backward_bf16_cta"
_MMA_WEIGHTS = {"f32": "odefunc_backward_mma_weights",
                "bf16": "odefunc_backward_bf16_mma_weights"}
_WITH_SCRATCH = (_ENTRY["bf16"], _MMA_WEIGHTS["bf16"])
_WEIGHT_GRADS = "odefunc_bwd_weight_grads"


def _lib() -> ctypes.CDLL:
    lib = _build.load("odefunc_bwd")
    for name in (*_ENTRY.values(), _CTA_BF16, *_MMA_WEIGHTS.values()):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p]
                           + [ctypes.c_void_p] * (name in _WITH_SCRATCH))
            fn.restype = ctypes.c_int
    fn = getattr(lib, _WEIGHT_GRADS)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def odefunc_bwd(params, t, h: torch.Tensor, g: torch.Tensor, *,
                groups: int = 32, with_f: bool = False,
                precision: str = "f32", residuals: dict | None = None):
    """VJP of f at ``(params, t, h)`` against ``g`` (B, H, W, C):
    ``(dparams, dt (B,), dh)`` with ``dparams`` in the raw ODEfunc layout,
    and the recomputed f(t, h) as a fourth value where ``with_f``.
    ``params``: an ODEfunc param dict or :class:`OdefuncWeights`; ``t``
    scalar or (B,).  ``precision``: 'f32', or 'bf16' for the VJP of the
    bf16 dynamics (the kernel's bf16 build on the card).  ``residuals``: a
    dict that a kernel launch fills with the scratch the weight gradients
    contracted, ``r1``, ``r2``, ``gu``, ``gv`` (B, H, W, C) (the arguments
    of :func:`weight_grad_emulated`; tests read them)."""
    b, hh, ww, c = h.shape
    w = prepare(params, (hh, ww))
    if h.device.type == "cpu":
        return odefunc_bwd_plain(w, t, h, g, groups, with_f, precision)
    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    out = launch(w, t, h, g, groups, _ENTRY[precision], residuals)
    if precision == "bf16":
        odefunc_bwd.launches_bf16 += 1
    else:
        odefunc_bwd.launches += 1
    return out if with_f else out[:3]


def launch(w: OdefuncWeights, t, h: torch.Tensor, g: torch.Tensor,
           groups: int, entry: str, residuals: dict | None = None):
    """One call of the C entry ``entry`` (``_ENTRY``'s, or a reading's:
    the bf16 build on the per-sample passes, ``odefunc_backward_bf16_cta``;
    either build with the ``mma.sync`` weight kernel, ``_MMA_WEIGHTS``) on
    CUDA tensors:
    ``(dparams, dt, dh, f)``.  Checks what the kernel takes and raises on
    anything else; counts nothing (:func:`odefunc_bwd` counts)."""
    b, hh, ww, c = h.shape
    if tuple(g.shape) != tuple(h.shape):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"state {tuple(h.shape)}")
    why = bwd_refusal((hh, ww), c, groups)
    if why is not None:
        raise ValueError(
            f"the CUDA ODEfunc backward kernel does not take H×W×C = "
            f"{hh}×{ww}×{c} with groups={groups}: {why} "
            "(kernels.odefunc_bwd.bwd_refusal)")
    check_cuda_inputs(w, {"h": h, "g": g}, (hh, ww), c, groups)
    rows = (entry in _WITH_SCRATCH
            and sample_pass((hh, ww), c, groups, "bf16") == "rows")
    if rows and b * hh * ww * c >= 2 ** 31:
        raise ValueError(f"the rows backward takes B·H·W·C < 2^31, got "
                         f"{b}×{hh}×{ww}×{c}")
    dev = h.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    t = t.reshape(-1).expand(b).contiguous()
    # The conv input gradient is a 3×3 conv of the cotangent with each tap's
    # (C, C) slice transposed and the taps in reverse order.  The
    # tensor-core stage reads w1, w2 that way itself; the FFMA stage takes
    # the rearranged copies.
    wbt = [] if stage((hh, ww), c) != "ffma" else [
        x.reshape(9, c, c).flip(0).transpose(1, 2).contiguous()
        for x in (w.w1, w.w2)]
    wbt_ptrs = [ptr(x) for x in wbt] or [None, None]
    n = hh * ww * c
    f = torch.empty_like(h)
    dh = torch.empty_like(h)
    # One allocation for the small outputs (dk, dvec, dt) and one for the
    # scratch (r1, r2, gu, gv, part, wpart, u where it does not fit in
    # shared memory or the rows backward runs, and the rows backward's own):
    # a step of the adjoint makes dozens of these calls, and the host
    # launches them.  Every piece is a multiple of four floats long (C is),
    # so each stays 16-byte aligned.
    nk = 9 * (c + 1) * c
    outs = torch.empty((2 * nk + 8 * c + b,), dtype=torch.float32, device=dev)
    dk = outs[:2 * nk].view(2, 3, 3, c + 1, c)
    dvec = outs[2 * nk:2 * nk + 8 * c].view(8, c)
    dt = outs[2 * nk + 8 * c:]
    ns = weight_splits(b, c)
    sizes = [b * n] * 4 + [b * _PARTS * c, ns * 2 * 9 * c * c,
                           b * n if rows or u_global((hh, ww), c, groups)
                           else 0,
                           rows_bwd_scratch_bytes(b, (hh, ww), c, groups) // 4
                           if rows else 0]
    scratch = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    offsets = [4 * sum(sizes[:i]) for i in range(len(sizes))]
    at = lambda base, nbytes: ctypes.c_void_p(base.data_ptr() + nbytes)
    lib = _lib()
    extra = [at(scratch, offsets[-1]) if rows else None] * (
        entry in _WITH_SCRATCH)
    code = getattr(lib, entry)(
        ptr(t), ptr(h), ptr(g), *weight_pointers(w), *wbt_ptrs,
        ptr(f), ptr(dh), at(outs, 4 * (2 * nk + 8 * c)),
        *(at(scratch, o) for o in offsets[:-1]),
        at(outs, 0), at(outs, 4 * nk), at(outs, 8 * nk),
        b, hh, ww, c, groups, ns, stream(), *extra)
    _build.check(lib, code, entry)
    if residuals is not None:
        residuals.update(zip(("r1", "r2", "gu", "gv"), (
            scratch[i * b * n:(i + 1) * b * n].view(b, hh, ww, c)
            for i in range(4))))
    dparams = {
        "norm1": {"scale": dvec[0], "bias": dvec[1]},
        "conv1": {"kernel": dk[0], "bias": dvec[6]},
        "norm2": {"scale": dvec[2], "bias": dvec[3]},
        "conv2": {"kernel": dk[1], "bias": dvec[7]},
        "norm3": {"scale": dvec[4], "bias": dvec[5]},
    }
    return dparams, dt, dh, f


odefunc_bwd.launches = odefunc_bwd.launches_bf16 = 0
