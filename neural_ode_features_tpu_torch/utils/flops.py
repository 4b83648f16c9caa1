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
kernels' bounds in ``chip_smoke.py`` and ``probes/conv_probe.py`` use.
"""

from __future__ import annotations

__all__ = [
    "odenet_flops_per_image",
    "odenet_train_flops_per_image",
    "peak_flops_per_chip",
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
