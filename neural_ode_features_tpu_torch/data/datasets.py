"""Datasets: the deterministic synthetic twins (port of
``neural_ode_features_tpu/data/datasets.py``).

``synthetic-mnist`` and ``synthetic-cifar10`` have the shapes, dtype and
class count of the real datasets and are generated from fixed numpy seeds;
this module is the port's own copy of the JAX package's generator, and the
bytes are the same (a test holds them equal).  Reading the raw MNIST and
CIFAR-10 files is not ported yet (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_dataset", "DATASETS", "dataset_spec"]

DATASETS = ("mnist", "cifar10", "synthetic-mnist", "synthetic-cifar10")

_SPECS = {
    "mnist": dict(shape=(28, 28, 1), n_train=60_000, n_test=10_000, classes=10),
    "cifar10": dict(shape=(32, 32, 3), n_train=50_000, n_test=10_000, classes=10),
}


def dataset_spec(name: str) -> dict:
    base = name.replace("synthetic-", "")
    return dict(_SPECS[base])


def _synthetic(base: str, split: str, n_override: int | None = None):
    """Class-conditional images: each sample is a convex mixture of its own
    class's smooth random template and ONE random distractor class's template
    (mixing weight uniform on [0, 0.5) — the true class always dominates, so labels
    are noise-free, but boundary samples are genuinely hard), plus a random
    spatial shift, amplitude jitter and pixel noise.  Deterministic in
    (base, split).

    The round-1 twins saturated at top-1 = 1.0000 by epoch 2, which made the
    accuracy axis unable to discriminate anything (solver tolerance, bf16,
    adjoint mode all scored identically — VERDICT r1 weak #5).  The mixture
    puts a controlled mass of samples near decision boundaries: converged
    top-1 lands in ~0.90–0.98 and small logit perturbations measurably move
    it, so accuracy-parity claims are falsifiable."""
    spec = _SPECS[base]
    h, w, c = spec["shape"]
    n = n_override or (spec["n_train"] if split == "train" else spec["n_test"])
    k = spec["classes"]
    rng = np.random.default_rng(712 if split == "train" else 713)

    # Smooth low-frequency class templates (shared across splits).
    trng = np.random.default_rng(714)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    templates = np.zeros((k, h, w, c))
    for cls in range(k):
        for ch in range(c):
            img = np.zeros((h, w))
            for _ in range(4):
                fx, fy = trng.uniform(0.15, 0.6, 2)
                px, py = trng.uniform(0, 2 * np.pi, 2)
                amp = trng.uniform(0.5, 1.0)
                img += amp * np.sin(fx * xx + px) * np.sin(fy * yy + py)
            templates[cls, :, :, ch] = img
    templates -= templates.min(axis=(1, 2, 3), keepdims=True)
    templates /= templates.max(axis=(1, 2, 3), keepdims=True)

    labels = rng.integers(0, k, size=n).astype(np.uint8)
    # Distractor class (never the true class) and mixing weight: a flat
    # weight distribution on [0, 0.5] — samples near mix = 0.5 are close to
    # genuinely ambiguous (plus pixel noise), the hard tail that pins
    # converged top-1 in the discriminative ~0.95–0.98 band.
    distract = (labels + rng.integers(1, k, size=n)) % k
    mix = rng.uniform(0.0, 0.5, size=(n, 1, 1, 1))
    shifts = rng.integers(-3, 4, size=(n, 2))
    amps = rng.uniform(0.7, 1.0, size=(n, 1, 1, 1))
    noise = rng.normal(0.0, 0.12, size=(n, h, w, c))

    base_imgs = (1.0 - mix) * templates[labels] + mix * templates[distract]
    rolled = np.empty_like(base_imgs)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            m = (shifts[:, 0] == dy) & (shifts[:, 1] == dx)
            if m.any():
                rolled[m] = np.roll(base_imgs[m], (dy, dx), axis=(1, 2))
    # In-place finish, bit-identical to `clip(rolled*amps + noise)`: the
    # out-of-place form held four (n,h,w,c) f64 arrays live at once (~5 GB
    # for the CIFAR train split — code-review r4).  The generated bytes
    # must NOT change (every persisted accuracy claim is keyed to them), so
    # the fix is lifetime management, not a dtype change.
    del base_imgs
    rolled *= amps
    rolled += noise
    del noise
    np.clip(rolled, 0.0, 1.0, out=rolled)
    rolled *= 255
    return rolled.astype(np.uint8), labels


def load_dataset(
    name: str,
    split: str,
    data_dir: str | None = None,
    *,
    limit: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return ``(images uint8 NHWC, labels uint8)`` for ``split`` in
    {'train', 'test'}.  ``limit`` truncates (a synthetic twin generates
    exactly ``limit`` samples).  ``data_dir`` is read only by the raw-file
    loaders, which are not ported yet."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: {DATASETS}")
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train'|'test', got {split!r}")
    if not name.startswith("synthetic-"):
        raise NotImplementedError(
            f"reading the raw {name} files is not ported yet (ROADMAP.md, "
            f"Queue 1 item 5); use 'synthetic-{name}'")
    x, y = _synthetic(name.replace("synthetic-", ""), split, limit)
    if limit is not None:
        x, y = x[:limit], y[:limit]
    return x, y
