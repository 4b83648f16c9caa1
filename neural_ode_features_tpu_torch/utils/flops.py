"""Analytic FLOP accounting for the ODE-Net, and the H100's peak rates
(port of the JAX package's ``utils/flops.py``).

Model-FLOPs utilisation (MFU) for the headline bench: count the *useful*
work (stem + head + mean-NFE dynamics evaluations per image) and divide
the achieved FLOP/s by the card's peak.  Per-sample adaptive stepping
runs the batch to its largest NFE (a done row still takes its attempt's
launch), so MFU here is the model-FLOPs convention (useful work), not
occupancy; the gap between the two is what the per-sample design pays for
its stragglers.  The two counting functions are copies of the JAX ones:
the same arithmetic, the same keys, both ``downsampling`` branches.

The H100 SXM's published dense peaks (NVIDIA's data sheet, at the 700 W
power limit) live here, the one home of the card's rates: the bf16 tensor
cores (:data:`H100_BF16_FLOPS`, the MFU denominator), TF32 on the tensor
cores (:data:`H100_TF32_FLOPS`), f32 FFMA outside them
(:data:`H100_F32_FLOPS`) and HBM3 (:data:`H100_HBM_BYTES_PER_S`), which the
kernels' bounds in ``chip_smoke.py`` and ``probes/conv_probe.py`` use;
:func:`bounds` turns operations and bytes into a bound, and
:func:`bwd_kernel_bounds` gives each of the backward kernel's three
launches its own (:func:`bwd_kernel_work` counts their work), and
:func:`rows_sample_bounds` the rows builds' per-sample GroupNorm launches
theirs (:func:`rows_sample_bytes`).
"""

from __future__ import annotations

__all__ = [
    "odenet_flops_per_image",
    "odenet_train_flops_per_image",
    "peak_flops_per_chip",
    "bounds",
    "bwd_kernel_work",
    "bwd_kernel_bounds",
    "rows_sample_bytes",
    "rows_sample_bounds",
    "H100_BF16_FLOPS",
    "H100_TF32_FLOPS",
    "H100_F32_FLOPS",
    "H100_HBM_BYTES_PER_S",
]

H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense
H100_TF32_FLOPS = 495e12       # TF32 tensor cores, dense
H100_F32_FLOPS = 67e12         # f32 FFMA, outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3


def _conv_flops(k: int, cin: int, cout: int, out_hw: int) -> float:
    # 2 (MAC) × k² × Cin × Cout per output pixel.
    return 2.0 * k * k * cin * cout * out_hw * out_hw


def _gn_flops(hw: int, ch: int) -> float:
    # mean, var, normalise, affine ≈ 8 ops per element (reduction + scale).
    return 8.0 * hw * hw * ch


def odenet_flops_per_image(cfg, image_side: int, mean_nfe: float) -> dict:
    """Analytic forward FLOPs for one image at ``mean_nfe`` dynamics evals.

    Only the 'conv' stem is modelled exactly (the bench default); the 'res'
    stem reuses the same feature-map sizes with its extra convs.  Returns a
    dict with per-part and total FLOPs so the bench JSON can expose the
    breakdown.
    """
    h = cfg.hidden
    s0 = image_side - 2  # conv0 3×3 VALID
    s1 = (s0 + 2 - 4) // 2 + 1  # 4×4 stride-2 pad-1
    s2 = (s1 + 2 - 4) // 2 + 1  # feature-map side inside the ODE block

    if cfg.downsampling == "res":
        stem = (
            _conv_flops(3, cfg.in_channels, h, s0)
            + 2 * _gn_flops(s0, h)
            # block1: 3×3 s2, 3×3, 1×1 s2 shortcut (at s1), GNs
            + _conv_flops(3, h, h, s1) + _conv_flops(3, h, h, s1)
            + _conv_flops(1, h, h, s1) + 2 * _gn_flops(s1, h)
            + _conv_flops(3, h, h, s2) + _conv_flops(3, h, h, s2)
            + _conv_flops(1, h, h, s2) + 2 * _gn_flops(s2, h)
        )
    else:
        stem = (
            _conv_flops(3, cfg.in_channels, h, s0)
            + _gn_flops(s0, h)
            + _conv_flops(4, h, h, s1)
            + _gn_flops(s1, h)
            + _conv_flops(4, h, h, s2)
        )

    # ODEfunc: GN → ReLU → 3×3 conv (h+1 → h) ×2 → GN, all at s2×s2.
    odefunc = (
        3 * _gn_flops(s2, h)
        + 2 * _conv_flops(3, h + 1, h, s2)
    )

    head = _gn_flops(s2, h) + 2.0 * h * cfg.num_classes

    total = stem + head + float(mean_nfe) * odefunc
    return {
        "stem": stem,
        "odefunc_per_eval": odefunc,
        "head": head,
        "total": total,
        "feature_side": s2,
    }


def odenet_train_flops_per_image(
    cfg, image_side: int, nfe_f: float, nfe_b: float
) -> dict:
    """Analytic TRAINING-step FLOPs for one image (adjoint route).

    Counting convention (the standard fwd:bwd ≈ 1:2 rule applied to this
    model's actual eval counts, which differ between the two passes):

    * stem + head: forward once, backward ≈ 2× (grads w.r.t. inputs AND
      parameters) → 3× their forward FLOPs;
    * dynamics forward: ``nfe_f`` ODEfunc evals;
    * dynamics backward (reintegrate adjoint): each of the ``nfe_b``
      augmented evals computes f once (the co-integrated y column) plus
      its VJP (≈ 2× f) → 3× ODEfunc per backward eval.  The seminorm /
      interpolated variants change ``nfe_b`` itself, not the per-eval
      cost (interpolated drops the y column but adds interpolant
      evaluation — within the model error of this estimate).

    Optimizer update / augmentation / loss are O(params + pixels) —
    negligible next to the convs — and excluded, consistent with
    :func:`odenet_flops_per_image`'s model-FLOPs (useful work) convention.
    """
    fwd = odenet_flops_per_image(cfg, image_side, 0.0)
    odefunc = fwd["odefunc_per_eval"]
    total = (
        3.0 * (fwd["stem"] + fwd["head"])
        + float(nfe_f) * odefunc
        + 3.0 * float(nfe_b) * odefunc
    )
    return {
        "stem_head_x3": 3.0 * (fwd["stem"] + fwd["head"]),
        "odefunc_per_eval": odefunc,
        "forward_dyn": float(nfe_f) * odefunc,
        "backward_dyn": 3.0 * float(nfe_b) * odefunc,
        "total": total,
        "feature_side": fwd["feature_side"],
    }


def peak_flops_per_chip(device_kind: str) -> float | None:
    """The card's dense bf16 tensor-core peak in FLOP/s, from
    ``torch.cuda.get_device_name()``; None for a name it does not know (the
    CPU among them): callers emit ``mfu = null`` then.

    An H100 SXM (a name with "H100" and neither "PCIe" nor "NVL", such as
    "NVIDIA H100 80GB HBM3") gives :data:`H100_BF16_FLOPS`; the PCIe and
    NVL parts have other peaks and are not known here.

    The bf16 peak is the denominator for f32 runs too.  That is the JAX
    package's convention, kept so that ``mfu`` means one thing in both
    packages: there the TPU's default precision ran f32 convs as bf16
    multiplies.  On the card an f32 run takes 3×TF32 tensor-core products
    (f32-grade sums) with TF32 off in cuDNN, so its MFU is its useful work
    over the card's highest dense rate, a lower share than against the
    TF32 peak (:data:`H100_TF32_FLOPS`), and comparable across dtypes."""
    kind = device_kind.lower()
    if "h100" in kind and "pcie" not in kind and "nvl" not in kind:
        return H100_BF16_FLOPS
    return None


def bounds(flops: float, nbytes: float,
           tensor_peak: float = H100_TF32_FLOPS) -> dict:
    """The card's least time for ``flops`` operations that move ``nbytes``
    bytes, with the tensor cores (the operations counted once, at the TF32
    rate, or ``tensor_peak``: bf16's for the bf16 builds) and on the CUDA
    cores (f32 FFMA): each the larger of its operations time and the bytes
    time at HBM's rate.  Returns ``bound_ms``, ``bound_by`` ("operations"
    or "bytes") and the same two under ``ffma_``."""
    out = {}
    for key, peak in (("", tensor_peak), ("ffma_", H100_F32_FLOPS)):
        by_ops, by_bytes = flops / peak, nbytes / H100_HBM_BYTES_PER_S
        out[key + "bound_ms"] = 1e3 * max(by_ops, by_bytes)
        out[key + "bound_by"] = ("operations" if by_ops >= by_bytes
                                 else "bytes")
    return out


def bwd_kernel_work(hw: tuple[int, int], c: int, b: int,
                    splits: int) -> dict:
    """Operations and bytes of each launch of the ODEfunc backward kernel
    (``csrc/odefunc_bwd.cu``) at H×W×C = (*hw, c) and batch ``b`` (f32
    storage), each input read once and each output written once, for the
    launches' bounds (:func:`bwd_kernel_bounds`).  ``bwd_sample_kernel``:
    four 3×3 convs a sample (the forward's two, the two input gradients);
    reads h, g, t and the laid-out weights (two (9, C, C) kernels, two
    (H·W, C) time maps, eight (C,) vectors), writes f, dh, dt, the four
    (B, H·W·C) residuals r1, r2, gu, gv and the (B, 26, C) partial sums.
    ``bwd_weight_kernel``: the two weight-gradient contractions (a conv's
    operations each); reads the residuals and writes one (2, 9, C, C)
    result: the function's own bytes, not the ``splits`` chunks that this
    design writes in its place (those are the kernel's distance from its
    bound).  ``bwd_reduce_kernel``: one add per chunk and per sample's
    partial; reads the ``splits`` chunks and the partials, writes the raw
    dθ (two (3, 3, C+1, C) kernels, eight (C,) vectors).  Returns
    ``{name: (flops, bytes)}``."""
    n = hw[0] * hw[1] * c
    conv = 2.0 * hw[0] * hw[1] * 9 * c * c * b
    weights = 4 * (2 * 9 * c * c + 2 * hw[0] * hw[1] * c + 8 * c)
    wpart = 4 * splits * 2 * 9 * c * c
    parts = 4 * b * 26 * c
    dtheta = 4 * (2 * 9 * (c + 1) * c + 8 * c)
    return {
        "bwd_sample_kernel": (4 * conv, 4 * (2 * b * n + b) + weights
                              + 4 * (2 * b * n + b) + 4 * 4 * b * n + parts),
        "bwd_weight_kernel": (2 * conv, 4 * 4 * b * n + 4 * 2 * 9 * c * c),
        "bwd_reduce_kernel": (float(splits * 2 * 9 * c * c + b * 26 * c),
                              wpart + parts + dtheta),
    }


def bwd_kernel_bounds(hw: tuple[int, int], c: int, b: int, splits: int,
                      tensor_peak: float = H100_TF32_FLOPS) -> dict:
    """Each of the backward call's three kernels' :func:`bounds` at H×W×C =
    (*hw, c), batch ``b`` and ``splits`` weight-gradient chunks (the
    wrapper's ``kernels.odefunc_bwd.weight_splits``), from
    :func:`bwd_kernel_work`: ``{name: bounds}``."""
    return {k: bounds(ops, nbytes, tensor_peak)
            for k, (ops, nbytes) in bwd_kernel_work(hw, c, b, splits).items()}


def rows_sample_bytes(hw: tuple[int, int], c: int, b: int,
                      groups: int = 32) -> dict:
    """Bytes of each per-sample GroupNorm launch of the bf16 rows builds
    (``csrc/rows_conv.cuh`` ``rows_gn``; ``csrc/odefunc.cu``,
    ``csrc/odefunc_bwd.cu``) at H×W×C = (*hw, c), batch ``b``: each input
    read once and each output written once; they do no products, so bytes
    bind them.  A state-sized tensor is B·H·W·C floats (f32), the bf16 conv
    input half that.  The backward's five (B = 128 on its path): the
    recompute's GroupNorm → ReLU of h and of u (read the input, write r and
    the conv input, the statistics), ``gv`` (read v and g, write f, gv and
    the conv input, 12 of the 26 partial rows and conv2's per-channel t
    sums), ``gu`` (read u and the conv2 input gradient, the statistics and
    those t sums; write gu, the conv input, 12 partial rows, conv1's t sums
    and dt), ``dh`` (read h, the conv1 input gradient, the statistics,
    conv1's t sums and dt; write dh, 2 partial rows and dt); each also reads
    its GroupNorm's scale and bias and, ``gv`` and ``gu``, a time map.  The
    forward's three (B = 256 on its path): GroupNorm → ReLU of h and of u1
    (read f32, write the bf16 conv input), GN3 of u2 (read, write f).
    Returns ``{"bwd": {launch: bytes}, "fwd": {launch: bytes}}``."""
    n = b * hw[0] * hw[1] * c
    f32, half = 4 * n, 2 * n
    gn = 4 * 2 * c                  # a GroupNorm's scale and bias
    tmap = 4 * hw[0] * hw[1] * c
    stats, rows, chan = 4 * 2 * b * groups, 4 * b * c, 4 * b * c
    return {
        "bwd": {
            "gn_relu_h": f32 + gn + f32 + half + stats,
            "gn_relu_u": f32 + gn + f32 + half + stats,
            "gv": 2 * f32 + 4 * b + gn + tmap + 2 * f32 + half + 12 * rows
            + chan,
            "gu": 2 * f32 + stats + 4 * b + gn + tmap + chan + f32 + half
            + 12 * rows + chan + 4 * b,
            "dh": 2 * f32 + stats + gn + chan + 4 * b + f32 + 2 * rows + 4 * b,
        },
        "fwd": {
            "gn_relu_h": f32 + gn + half,
            "gn_relu_u": f32 + gn + half,
            "gn_out": f32 + gn + f32,
        },
    }


def rows_sample_bounds(hw: tuple[int, int], c: int, b: int,
                       groups: int = 32) -> dict:
    """The least time of the rows builds' per-sample launches by their
    bytes at HBM's rate (:func:`rows_sample_bytes`), each direction's
    launches summed: ``{"bwd": {"bytes", "bound_ms", "bound_by"}, "fwd":
    ...}``.  At B = 128, 7×7×512 the backward's five move 213.7 MB (205.5 MB
    of state-sized tensors, the rest partial rows, statistics and t sums),
    0.0638 ms; at B = 256 the forward's three 128.5 MB, 0.0383 ms."""
    out = {}
    for key, launches in rows_sample_bytes(hw, c, b, groups).items():
        nbytes = float(sum(launches.values()))
        out[key] = {"bytes": nbytes, **{
            k: v for k, v in bounds(0.0, nbytes).items()
            if not k.startswith("ffma_")}}
    return out
