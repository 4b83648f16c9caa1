"""Fused ODEfunc kernel: f(t, h) = GN→ReLU→ConcatConv3×3→GN→ReLU→
ConcatConv3×3→GN in one CUDA launch, one CTA per sample.

Replaces the TPU kernel ``neural_ode_features_tpu/kernels/odefunc_pallas.py``
(``_odefunc_pallas`` → ``_odefunc_kernel``).  Source: ``csrc/odefunc.cu``
with the per-sample code in ``csrc/odefunc_common.cuh``.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 495 TFLOP/s TF32 on them, 3.35 TB/s): the two 3×3 convs are
2 · 2·H·W·9C·C FLOP per sample, 1.85 GFLOP at B = 256, 7×7×64, i.e. about
28 µs of FFMA or 3.7 µs of TF32 products; the bytes (state in and out,
0.3 MB of weights) are 6.7 MB, about 2 µs.  So it is bound by operations.
The design keeps the sample in shared memory for the whole chain (state,
padded conv input, GroupNorm scratch) and streams each conv tap's f32
weights into shared memory once per CTA.  The convs have three stages,
chosen from the shape and the precision alone (:func:`stage`): at C a
multiple of 32 from 64 to 512 with H·(W+2) ≤ 64 (7×7 CIFAR-10 and 6×6
MNIST maps) an implicit GEMM on the tensor cores, TF32 with 3×TF32 error
compensation (each f32 operand split into a TF32 head and tail, three
products per pair, f32 accumulation), which is f32-grade, in 64-channel
blocks of output and input channels (the last one padded with zeros where
C % 64 == 32): ``'wgmma3'``, Hopper's ``wgmma.mma_async`` with each weight
tile copied in by ``cp.async.bulk`` behind an mbarrier and split once per
CTA, at the widths of ``WGMMA_C`` (7×7×64 and 6×6×64 among them), and
``'mma3'``, ``mma.sync`` with weights staged by ``cp.async``, at the
others; at every other supported shape (C = 32, say) register-tiled f32
FFMA.  From C = 96 one CTA fills an SM's shared memory, and the
kernels run a second build of themselves for one CTA per SM (up to 128
registers a thread); the other shapes keep two CTAs per SM and 64
registers.  Where a wide shape's working set outgrows the 227 KB
(:func:`layout`), the state moves to per-sample global scratch and then the
weight ring drops from three buffers to two: 7×7×512 runs that way.
PyTorch's own TF32 switches stay off: the kernels' TF32 is explicit and
compensated, a library's is not.

``compute_dtype=torch.bfloat16`` runs a second build of the kernel (the
operator ``nodef::odefunc_bf16``): the port's plain bf16 dynamics (the
JAX jnp path's, :func:`odefunc_plain` with ``precision='bf16'``), h
rounded to bf16 on entry, each GroupNorm's normalised value, scale product
and bias sum rounded (statistics in f32), both convs on the bf16 conv stage
(bf16 products, f32 accumulation: ``'wgmma_bf16'``, Hopper's
``wgmma.mma_async`` bf16 with each weight tile converted once per CTA, at
the widths of ``WGMMA_C``; f32 FFMA on bf16-rounded operands at the FFMA
shapes), then the conv output, its sum with the bias, t·M and the last sum
each rounded; f returns as float32 holding bf16 values.  At the other
tensor-core shapes (C = 96 to 512, ``'rows_bf16'``) one call is the rows
build: a fixed sequence of seven launches on the current stream, with no
atomics (``csrc/odefunc.cu``): GN1 → ReLU into a bf16 scratch copy of the
conv input; conv1 as one bf16 ``wgmma`` GEMM over the rows of every sample
(``csrc/rows_conv.cuh``: its weights rounded and laid out once per call,
128 output channels a CTA, 64- or 128-row tiles) whose epilogue adds bias
and t·M; GN2 → ReLU; conv2; GN3.  Each GroupNorm launch splits a sample
over :func:`rows_slices` CTAs of :func:`rows_slice_threads` threads, a
slice of whole groups each, staged into shared memory by 16-byte copies.
It gives the per-sample build's bits (each slice holds the per-sample
kernel's (pixel group, channel) slots for its channels and adds in its
order, and the convs sum in ``mma.sync``'s order), which stays readable
alone through
``probes/timing_aids.py`` ``odefunc_cta_bf16``; the scratch
(:func:`rows_scratch_bytes`) comes from PyTorch's caching allocator on the
current stream.  The conv output is rounded before the bias add, as
cuDNN's bf16 conv and PyTorch's bias add round on the card and as the JAX
jnp path rounds; on the CPU the library folds the bias into the conv's one
rounding, which puts the kernel within a few u of the CPU's plain version
(``tests/test_torch_bf16_kernels.py``).  It takes
exactly the shapes and layouts of the f32 build.  Bound at B = 256,
7×7×64: 1.85 GFLOP at 989 TFLOP/s dense bf16 against 6.4 MB at
3.35 TB/s, about 1.9 µs, bound by bytes.

``odefunc`` is the wrapper, one call of the operator ``nodef::odefunc``
(``kernels/ops.py``): a CPU tensor takes the plain PyTorch version
``odefunc_plain`` (which the tests hold against the JAX package); a CUDA
tensor launches the kernel (:func:`launch`) or raises.
``odefunc.launches`` counts the f32 build's launches,
``odefunc.launches_bf16`` the bf16 build's.

The VJP pair (the counterpart of the JAX ``odefunc_pallas_vjp``, and for
``compute_dtype=torch.bfloat16`` of ``jax.vjp`` of the jnp bf16 dynamics):
``odefunc_autograd`` is a ``torch.autograd.Function`` whose forward is this
kernel and whose backward is the fused backward kernel
(``kernels/odefunc_bwd.py``), each in the build of ``compute_dtype``;
``odefunc_vjp`` gives ``(f, dθ, dt, dh)`` in one call, for the adjoint's
augmented dynamics.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..ops.layers import conv2d, group_norm, time_map
from . import _build

__all__ = ["OdefuncWeights", "Layout", "prepare", "supported", "refusal",
           "layout", "smem_bytes", "mma_ok", "stage", "odefunc", "odefunc_plain",
           "odefunc_autograd", "odefunc_vjp", "PRECISIONS", "bf16_round",
           "rows_scratch_bytes", "rows_pack_bytes", "rows_ntiles", "ROWS_K",
           "ROWS_NB", "ROWS_SLICE", "ROWS_SLICES", "rows_slices",
           "rows_slice_threads", "rows_gn_smem_bytes"]

# Mirrors csrc/odefunc_common.cuh (kThreads, kMaxC, kMaxPix, kMaxSmem;
# kMmaC, kMmaStep, kMmaM, kPadA, kPitchBT, kRing of the tensor-core stage;
# kWgFloats, wgmma3's weight area; wgmma_ok's widths).
THREADS = 512
MAX_C = 512
MAX_PIX = 8
MAX_SMEM = 232448 - 1024
MMA_C = 64
MMA_STEP = 32
MMA_M = 64
PAD_A = 8
PITCH_BT = 72
RING = 3
WG_FLOATS = 3 * MMA_C * MMA_C + 4
WGMMA_C = (64,)
# odefunc_plain's precisions (csrc/odefunc_common.cuh kF32, kBf16Conv, kBf16).
PRECISIONS = ("f32", "bf16_conv", "bf16")


class OdefuncWeights(NamedTuple):
    """ODEfunc parameters laid out for the kernels, f32 and contiguous:
    conv kernels split into the state part ``w`` (3, 3, C, C) HWIO and the
    border-aware time maps ``m`` (H, W, C) of the split ConcatConv."""

    n1s: torch.Tensor
    n1b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    m1: torch.Tensor
    n2s: torch.Tensor
    n2b: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    m2: torch.Tensor
    n3s: torch.Tensor
    n3b: torch.Tensor


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even), in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def prepare(params, hw: tuple[int, int]) -> OdefuncWeights:
    """Lay out an ODEfunc param dict (``norm1/conv1/norm2/conv2/norm3``,
    conv kernels (3, 3, C+1, C)) for maps of spatial shape ``hw``.  The time
    maps are computed here once, in strict f32.  Both builds of the kernel
    take this f32 layout (the bf16 build rounds what it reads, as the plain
    bf16 path casts).  Weights already laid out are returned as they are."""
    if isinstance(params, OdefuncWeights):
        return params
    hh, ww = hw

    def f32(x):
        return x.float().contiguous()

    def conv(name):
        k = params[name]["kernel"].float()
        return (f32(k[:, :, 1:, :]), f32(params[name]["bias"]),
                f32(time_map(k, hh, ww)))

    w1, b1, m1 = conv("conv1")
    w2, b2, m2 = conv("conv2")
    return OdefuncWeights(
        f32(params["norm1"]["scale"]), f32(params["norm1"]["bias"]), w1, b1, m1,
        f32(params["norm2"]["scale"]), f32(params["norm2"]["bias"]), w2, b2, m2,
        f32(params["norm3"]["scale"]), f32(params["norm3"]["bias"]))


def mma_ok(hw: tuple[int, int], c: int) -> bool:
    """The shapes the tensor-core stages take (csrc/odefunc_common.cuh
    ``mma_ok``): C a multiple of 32 from 64 to 512 (64-channel blocks, the
    last one padded where C % 64 == 32) and maps whose H·(W+2)
    padded-pitch positions fit a 64-row tile."""
    hh, ww = hw
    return (MMA_C <= c <= MAX_C and c % MMA_STEP == 0 and hh >= 1
            and ww >= 1 and hh * (ww + 2) <= MMA_M)


def stage(hw: tuple[int, int], c: int, precision: str = "f32") -> str:
    """The conv stage the fused kernels' builds of ``precision`` (one of
    ``PRECISIONS``) run at this shape, decided by the shape and the
    precision alone (csrc/odefunc_common.cuh ``mma_ok``, ``wgmma_ok``,
    ``make_shape``).  At the tensor-core shapes (:func:`mma_ok`) of the
    widths of ``WGMMA_C`` the f32 builds run ``'wgmma3'``
    (``wgmma.mma_async``, 3×TF32) and the bf16 builds (``'bf16'``, and the
    fused step's ``'bf16_conv'``) ``'wgmma_bf16'`` (``wgmma.mma_async``,
    one bf16 pass); at the other widths ``'mma3'`` (``mma.sync``: 3×TF32,
    or its one bf16 pass in the fused step's ``'bf16_conv'`` build), except
    that the ``'bf16'`` dynamics there (C = 96 to 512) run ``'rows_bf16'``:
    the rows build of ``csrc/odefunc.cu`` (C++ ``rows_build_ok``), each
    conv one bf16 ``wgmma`` GEMM over the rows of every sample, in place of
    one CTA per sample on ``mma.sync``.  The backward's
    input-gradient convs run ``'mma3'`` at every tensor-core shape but in
    its cluster pass (``kernels.odefunc_bwd.sample_pass``), which runs them
    on ``wgmma``, and in the bf16 build's rows backward at the
    ``'rows_bf16'`` shapes, which runs all four of its convs on the rows
    conv (the input gradients on its transposed packing); everything else
    runs ``'ffma'``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if mma_ok(hw, c):
        if c in WGMMA_C:
            return "wgmma3" if precision == "f32" else "wgmma_bf16"
        return "rows_bf16" if precision == "bf16" else "mma3"
    return "ffma"


class Layout(NamedTuple):
    """Where a kernel keeps one sample's working set (csrc/odefunc_common.cuh
    ``fit_layout``): its conv stage, the weight buffers of the ``mma3``
    stage (``ring``), whether the state x and, in the backward, the conv1
    output u live in per-sample global scratch in place of shared memory,
    and the dynamic shared memory in bytes."""

    stage: str
    ring: int
    x_global: bool
    u_global: bool
    smem: int


def layout(hw: tuple[int, int], c: int, groups: int,
           conv_stage: str | None = None, backward: bool = False) -> Layout:
    """The layout of the forward kernels (``backward=False``: ``odefunc``,
    ``rk_step``, the probe) or of the backward's per-sample pass, under
    ``conv_stage`` (default: the shape's own, :func:`stage`).  Shared memory
    (``odefunc_smem_bytes``): the state x (H·W·C floats) unless
    ``x_global``; the conv input with a zero border, whose rows the
    tensor-core stage pads to 64·⌈C/64⌉ + 8 floats and of which it keeps
    64 + 2(W+2) + 2 (slack for the last tile's taps); the weights, a ring of
    (64, 72) buffers or the FFMA stage's two (C, C) buffers; 2·512 partial
    sums and 2·G statistics.  Under ``'wgmma3'`` the weight area holds the
    larger of the ring (which the backward's input-gradient convs run in
    the same area) and that stage's own (``WG_FLOATS``: its TF32 head and
    tail tiles, its f32 tile and two mbarriers, 3·64·64 + 4 floats, within a
    ring of three).  The backward adds 6·G statistics, 4·C channel sums and
    u unless ``u_global``.  A wide shape (tensor cores, C > 64) that does
    not fit moves u, then x to global scratch, then drops the ring to two
    buffers; the values do not depend on the layout."""
    hh, ww = hw
    conv_stage = conv_stage or stage(hw, c)
    hwc = hh * ww * c
    mma = conv_stage in ("mma3", "wgmma3", "wgmma_bf16")
    if mma:
        pad = (MMA_M + 2 * (ww + 2) + 2) * (MMA_C * -(-c // MMA_C) + PAD_A)
    else:
        pad = (hh + 2) * (ww + 2) * c

    def nbytes(ring, xg, ug):
        weights = ring * MMA_C * PITCH_BT if mma else 2 * c * c
        if conv_stage in ("wgmma3", "wgmma_bf16"):
            weights = max(weights, WG_FLOATS)
        fwd = (0 if xg else hwc) + pad + weights + 2 * THREADS + 2 * groups
        bwd = 6 * groups + 4 * c + (0 if ug else hwc) if backward else 0
        return 4 * (fwd + bwd)

    ring, xg, ug = RING, False, False
    if mma and c > MMA_C:
        if backward and nbytes(ring, xg, ug) > MAX_SMEM:
            ug = True
        if nbytes(ring, xg, ug) > MAX_SMEM:
            xg = True
        if nbytes(ring, xg, ug) > MAX_SMEM:
            ring = 2
    return Layout(conv_stage, ring, xg, ug, nbytes(ring, xg, ug))


def smem_bytes(hw: tuple[int, int], c: int, groups: int,
               conv_stage: str | None = None) -> int:
    """Dynamic shared memory per CTA of the forward kernels (:func:`layout`)."""
    return layout(hw, c, groups, conv_stage).smem


def refusal(hw: tuple[int, int], c: int, groups: int,
            conv_stage: str | None = None) -> str | None:
    """Why the kernels do not take this shape, or None where they do: the
    gate of csrc/odefunc_common.cuh ``layout_ok``.  The JAX kernels' own
    gate (``pallas_supported``: C % groups == 0 and C ≤ 512) comes first;
    then C divisible by 4, the working set within the 227 KB of shared
    memory and, for the FFMA stage, C dividing the CTA's 512 threads and at
    most 8 conv pixels per thread.  On 7×7 (CIFAR-10) and 6×6 (MNIST) maps
    with groups 32 the kernels take exactly the widths the JAX kernels take:
    C = 32 on the FFMA stage, every multiple of 32 from 64 to 512 on the
    tensor cores.  ``conv_stage='ffma'`` asks for the FFMA layout at any
    shape (the conv probe's ``tap9``)."""
    hh, ww = hw
    if groups < 1 or c < 1 or c % groups:
        return f"C % groups != 0 (C = {c}, groups = {groups})"
    if c > MAX_C:
        return f"C > {MAX_C} (C = {c})"
    if hh < 1 or ww < 1 or c % 4:
        return "H, W >= 1 and C a multiple of 4"
    lay = layout(hw, c, groups, conv_stage)
    if lay.stage == "ffma" and THREADS % c:
        return (f"on the FFMA stage (C < {MMA_C}, not a multiple of "
                f"{MMA_STEP}, or maps with H·(W+2) > {MMA_M}) C must divide "
                f"{THREADS}")
    if lay.smem > MAX_SMEM:
        return (f"the working set ({lay.smem} B) exceeds the {MAX_SMEM} B of "
                "shared memory")
    if (lay.stage == "ffma"
            and math.ceil(hh * ww / (THREADS // c)) > MAX_PIX):
        return f"more than {MAX_PIX} conv pixels per thread on the FFMA stage"
    return None


def supported(hw: tuple[int, int], c: int, groups: int,
              conv_stage: str | None = None) -> bool:
    """The kernels' shape gate: :func:`refusal` finds nothing."""
    return refusal(hw, c, groups, conv_stage) is None


def odefunc_plain(w: OdefuncWeights, t, h: torch.Tensor, groups: int,
                  precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, with the
    same split ConcatConv (conv + b + t·M).  ``precision``: ``'f32'``, in
    ``h``'s dtype; ``'bf16_conv'``, the fused step's
    ``conv_precision='bf16'``: each conv's operands rounded to bf16, the
    products and everything else in ``h``'s dtype; ``'bf16'``, the bf16
    dynamics (``compute_dtype='bfloat16'``): the whole function in bfloat16
    as the port's CPU path computes it (``models.odenet.odefunc_apply``,
    ``ops.layers``), f returned in ``h``'s dtype."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    x = h.to(torch.bfloat16) if precision == "bf16" else h
    t = torch.as_tensor(t, dtype=x.dtype, device=h.device).reshape(-1, 1, 1, 1)
    op = bf16_round if precision == "bf16_conv" else (lambda a: a)

    def conv(out, kernel, bias, tmap):
        out = conv2d({"kernel": op(kernel), "bias": bias}, op(out), padding=1)
        return out + t * tmap.to(x.dtype)

    out = torch.relu(group_norm({"scale": w.n1s, "bias": w.n1b}, x,
                                groups=groups))
    out = conv(out, w.w1, w.b1, w.m1)
    out = torch.relu(group_norm({"scale": w.n2s, "bias": w.n2b}, out,
                                groups=groups))
    out = conv(out, w.w2, w.b2, w.m2)
    out = group_norm({"scale": w.n3s, "bias": w.n3b}, out, groups=groups)
    return out.to(h.dtype)


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address, for a C entry point."""
    return ctypes.c_void_p(x.data_ptr())


def check_device(hw, c: int, groups: int, device: torch.device) -> None:
    """Raise unless the kernels take this shape (:func:`refusal`, naming
    the clause) on this device (CUDA), from shapes alone: the gate of every
    launch (:func:`check_cuda_inputs`) and of the operators' fake versions
    (``kernels/ops.py``), which run while ``torch.export`` traces."""
    why = refusal(hw, c, groups)
    if why is not None:
        raise ValueError(
            f"the CUDA ODEfunc kernels do not take H×W×C = {hw[0]}×{hw[1]}×{c}"
            f" with groups={groups}: {why} (kernels.odefunc.refusal)")
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {device}")


def check_cuda_inputs(w: OdefuncWeights, states: dict, hw, c: int,
                      groups: int) -> None:
    """Validate what a kernel launch receives (``states``: name → tensor of
    the per-sample data); raise on anything the kernel does not take — there
    is no fallback on the card."""
    dev = next(iter(states.values())).device
    check_device(hw, c, groups, dev)
    shapes = {"w1": (3, 3, c, c), "w2": (3, 3, c, c),
              "m1": (hw[0], hw[1], c), "m2": (hw[0], hw[1], c)}
    for name, x in [*w._asdict().items(), *states.items()]:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             "aligned tensor")
        want = shapes.get(name, (c,)) if name in w._fields else None
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(x.shape)}")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if it is contiguous and 16-byte aligned (what the
    kernels take), else a copy that is: a view into the middle of a flat
    solver state (the adjoint's augmented state) may start anywhere."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def weight_pointers(w: OdefuncWeights) -> list[ctypes.c_void_p]:
    return [ptr(x) for x in w]


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# The C entry point of each build of the kernel (csrc/odefunc.cu); the bf16
# one takes the rows build's scratch last.
_ENTRY = {"f32": "odefunc_forward", "bf16": "odefunc_forward_bf16"}
# Mirrors csrc/rows_conv.cuh (kRowsK, kRowsNB, kRowsSlice): the rows
# conv's stage depth, 64-column blocks of an N tile and bytes of a 64-row
# slice of a stage.
ROWS_K = 64
ROWS_NB = 2
ROWS_SLICE = 64 * ROWS_K * 2


def rows_ntiles(c: int) -> int:
    """The rows conv's N tiles of ``ROWS_NB`` 64-column blocks at width C
    (csrc/rows_conv.cuh ``rows_ntiles``)."""
    return -(-(-(-c // ROWS_K)) // ROWS_NB)


def rows_pack_bytes(tap: bool, c: int) -> int:
    """Bytes of one conv's weights packed for the rows conv (csrc/
    rows_conv.cuh ``rows_pack_bytes``): every N tile's every stage's (128,
    64) bf16 slice in shared memory's order; a stage one tap's 64 input
    channels (``tap``) or 64 k of K = 9C."""
    stages = 9 * -(-c // ROWS_K) if tap else -(-9 * c // ROWS_K)
    return rows_ntiles(c) * stages * ROWS_NB * ROWS_SLICE


def rows_scratch_bytes(b: int, hw: tuple[int, int], c: int,
                       tap: bool = True) -> int:
    """Bytes of a call's scratch for the rows conv (csrc/rows_conv.cuh
    ``rows_scratch_bytes``): the bf16 conv input of the batch, rounded up to
    1 KB, and one conv's packed weights (:func:`rows_pack_bytes`; the rows
    build's stages are one tap's channels, the probe's ``im2col_bf16``'s 64
    k of K = 9C)."""
    return (-(-(b * hw[0] * hw[1] * c * 2) // 1024) * 1024
            + rows_pack_bytes(tap, c))


# Mirrors csrc/rows_conv.cuh (kRowsSlices): the slices of a sample in the
# rows builds' per-sample GroupNorm launches, where the group count allows.
ROWS_SLICES = 4


def rows_slices(groups: int) -> int:
    """The CTAs a sample's GroupNorm is split over in the rows builds'
    per-sample launches (csrc/rows_conv.cuh ``rows_slices``):
    ``ROWS_SLICES``, or the largest power of two below it that divides the
    group count, so that every slice holds whole groups (groups are
    contiguous channels).  The launches' grid is B times this."""
    n = ROWS_SLICES
    while n > 1 and groups % n:
        n //= 2
    return n


def rows_slice_threads(groups: int) -> int:
    """Threads of one slice's CTA (csrc/rows_conv.cuh
    ``rows_slice_threads``): the one-CTA map's 512 over the slices, which
    holds the slice's ``(pixel group, channel)`` slots, one a thread."""
    return THREADS // rows_slices(groups)


def rows_gn_smem_bytes(hw: tuple[int, int], c: int, groups: int) -> int:
    """Dynamic shared memory of a rows-build GroupNorm launch (csrc/
    rows_conv.cuh ``rows_gn_smem_bytes``): the slice staged (H·W·C/slices
    floats), two partial sums a thread and its groups' mean and inv.
    26,176 bytes at 7×7×512 with 32 groups."""
    n = rows_slices(groups)
    return 4 * (hw[0] * hw[1] * (c // n) + 2 * (THREADS // n)
                + 2 * (groups // n))


def _lib() -> ctypes.CDLL:
    lib = _build.load("odefunc")
    for name in (*_ENTRY.values(), "odefunc_forward_bf16_cta"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p]
                           + [ctypes.c_void_p] * (name == _ENTRY["bf16"]))
            fn.restype = ctypes.c_int
    return lib


def launch(w: OdefuncWeights, t: torch.Tensor, h: torch.Tensor,
           groups: int, precision: str = "f32") -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (the CUDA side of the
    operators ``nodef::odefunc`` and, ``precision='bf16'``,
    ``nodef::odefunc_bf16``, ``kernels/ops.py``): ``t`` (B,) float32, ``h``
    (B, H, W, C).  Checks what the kernel takes and raises on anything
    else; counts the launch in ``odefunc.launches`` (the f32 build) or
    ``odefunc.launches_bf16``."""
    b, hh, ww, c = h.shape
    check_cuda_inputs(w, {"h": h}, (hh, ww), c, groups)
    out = torch.empty_like(h)
    lib = _lib()
    entry = _ENTRY[precision]
    extra = []
    if precision == "bf16":
        scratch = None
        if stage((hh, ww), c, "bf16") == "rows_bf16":
            if b * hh * ww * c >= 2 ** 31:
                raise ValueError(
                    f"the rows build takes B·H·W·C < 2^31, got "
                    f"{b}×{hh}×{ww}×{c}")
            scratch = torch.empty(rows_scratch_bytes(b, (hh, ww), c),
                                  dtype=torch.uint8, device=h.device)
        extra = [None if scratch is None else ptr(scratch)]
    code = getattr(lib, entry)(
        ptr(t), ptr(h), *weight_pointers(w), ptr(out),
        b, hh, ww, c, groups, stream(), *extra)
    _build.check(lib, code, entry)
    if precision == "bf16":
        odefunc.launches_bf16 += 1
    else:
        odefunc.launches += 1
    return out


def odefunc(params, t, h: torch.Tensor, *, groups: int = 32,
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f(t, h) for ``h`` (B, H, W, C) float32 NHWC and ``t`` scalar or (B,).
    ``params``: an ODEfunc param dict or :class:`OdefuncWeights`.
    ``compute_dtype``: float32, or bfloat16 for the bf16 dynamics.  One
    call of the operator ``nodef::odefunc`` (``nodef::odefunc_bf16``): on a
    CUDA tensor the kernel's build, on a CPU tensor :func:`odefunc_plain`
    at that precision."""
    b, hh, ww, _ = h.shape
    bf16 = compute_dtype == torch.bfloat16
    w = prepare(params, (hh, ww))
    dtype = torch.float32 if h.is_cuda else h.dtype
    t = torch.as_tensor(t, dtype=dtype, device=h.device)
    t = t.reshape(-1).expand(b).contiguous()
    op = torch.ops.nodef.odefunc_bf16 if bf16 else torch.ops.nodef.odefunc
    return op(t, h, list(w), groups)


odefunc.launches = odefunc.launches_bf16 = 0


# The raw ODEfunc parameter leaves, in the order the VJP pair passes them.
PARAM_KEYS = (("norm1", "scale"), ("norm1", "bias"), ("conv1", "kernel"),
              ("conv1", "bias"), ("norm2", "scale"), ("norm2", "bias"),
              ("conv2", "kernel"), ("conv2", "bias"), ("norm3", "scale"),
              ("norm3", "bias"))


def _dt_like(dt_b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The per-sample t cotangent in ``t``'s own shape: the forward
    broadcasts a scalar or (1,) ``t`` to (B,), so its cotangent is the sum
    (JAX ``_vjp_bwd``)."""
    if t.numel() == 1:
        return dt_b.sum().reshape(t.shape).to(t.dtype)
    return dt_b.reshape(t.shape).to(t.dtype)


def _precision(compute_dtype: torch.dtype) -> str:
    """The kernels' precision name of a compute dtype."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return "bf16" if compute_dtype == torch.bfloat16 else "f32"


class _OdefuncVJP(torch.autograd.Function):
    """Forward: the ODEfunc kernel on the laid-out weights ``w``.  Backward:
    the fused backward kernel, which recomputes the forward, so the
    residuals are only ``(params, t, h)``; both in the build of
    ``compute_dtype``.  The gradients go to the raw parameter leaves that
    ``w`` was laid out from."""

    @staticmethod
    def forward(ctx, w, groups, compute_dtype, t, h, *leaves):
        ctx.w, ctx.groups, ctx.compute_dtype = w, groups, compute_dtype
        ctx.save_for_backward(t, h)
        return odefunc(w, t, h, groups=groups, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        from .odefunc_bwd import odefunc_bwd

        t, h = ctx.saved_tensors
        dparams, dt_b, dh = odefunc_bwd(
            ctx.w, t, h, g.contiguous(), groups=ctx.groups,
            precision=_precision(ctx.compute_dtype))
        return (None, None, None, _dt_like(dt_b, t), dh,
                *(dparams[a][b] for a, b in PARAM_KEYS))


def odefunc_autograd(params, t, h: torch.Tensor, *, groups: int = 32,
                     weights: OdefuncWeights | None = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """f(t, h), differentiable in the raw ``params`` (an ODEfunc param
    dict), ``t`` and ``h`` through the kernel pair in the build of
    ``compute_dtype`` (float32, or bfloat16 for the bf16 dynamics; on a CPU
    tensor the plain versions at that precision).  ``weights``: ``params``
    already laid out by :func:`prepare` (once per solve), else laid out
    here."""
    _precision(compute_dtype)
    if weights is None:
        with torch.no_grad():
            weights = prepare(params, tuple(h.shape[1:3]))
    t = torch.as_tensor(t, dtype=h.dtype, device=h.device)
    return _OdefuncVJP.apply(weights, groups, compute_dtype, t, h,
                             *(params[a][b] for a, b in PARAM_KEYS))


def odefunc_vjp(params, t, h: torch.Tensor, a: torch.Tensor, *,
                groups: int = 32,
                compute_dtype: torch.dtype = torch.float32):
    """``(f, dparams, dt, dh)``: f(t, h) and its VJP against ``a``, with
    ``dparams`` in the raw layout and ``dt`` in ``t``'s shape, for the
    dynamics of ``compute_dtype`` (float32 or bfloat16).  One call of the
    backward kernel's build on the card, which recomputes the forward and
    writes f itself; the ODEfunc kernel is not launched."""
    from .odefunc_bwd import odefunc_bwd

    w = prepare(params, tuple(h.shape[1:3]))
    t = torch.as_tensor(t, dtype=h.dtype, device=h.device)
    dparams, dt_b, dh, f = odefunc_bwd(w, t, h, a, groups=groups,
                                       with_f=True,
                                       precision=_precision(compute_dtype))
    return f, dparams, _dt_like(dt_b, t), dh
