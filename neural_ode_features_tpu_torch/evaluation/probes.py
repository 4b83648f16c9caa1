"""Downstream feature-quality metrics: linear probe, kNN, retrieval mAP (port
of ``neural_ode_features_tpu/evaluation/probes.py``).

Given per-t feature matrices, compute classification and retrieval quality
per t: the metric-vs-t curves.  The JAX package computes them on the host
with scikit-learn; the port computes them itself on tensors, on the device
(the card by default), and is held to scikit-learn's answers by its tests:

* retrieval mAP as the JAX one: a blocked f32 distance product (a plain
  matrix product outside any kernel, ``torch.matmul`` with TF32 off) and the
  precision arithmetic in float64;
* kNN: the k nearest by L2 with uniform votes; among classes with equal
  votes the lowest label wins (scikit-learn's rule);
* the linear probe: standardised features into an L2-regularised (C = 1.0)
  multinomial logistic regression, minimised with ``torch.optim.LBFGS`` in
  float64 (scikit-learn's ``LogisticRegression`` default objective; for two
  classes its binary form).

Features and labels may be numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import strict_f32

__all__ = ["linear_probe_acc", "knn_acc", "retrieval_map", "evaluate_features"]


def _tensor(a, dev, dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


def fit_linear_probe(x: torch.Tensor, y: torch.Tensor, n_classes: int, *,
                     c: float = 1.0, max_iter: int = 2000
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimise ``Σ_i CE(x_i W^T + b, y_i) + ||W||² / (2c)`` (the intercept
    is not penalised) from zero; ``x`` float64 (n, d), ``y`` int64 class
    indices.  Returns ``(W (K, d), b (K,))``; for two classes K is 1 and the
    logits are ``[0, x W^T + b]`` (the binary logistic loss)."""
    k = n_classes if n_classes > 2 else 1
    w = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device,
                    requires_grad=True)
    b = torch.zeros((k,), dtype=x.dtype, device=x.device, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=max_iter,
                            max_eval=4 * max_iter, tolerance_grad=1e-6,
                            tolerance_change=1e-12, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = (F.cross_entropy(_logits(x, w, b), y, reduction="sum")
                + (w * w).sum() / (2.0 * c)) / x.shape[0]
        loss.backward()
        return loss

    opt.step(closure)
    return w.detach(), b.detach()


def _logits(x, w, b):
    z = x @ w.T + b
    if w.shape[0] == 1:
        return torch.cat([torch.zeros_like(z), z], dim=1)
    return z


def linear_probe_acc(train_f, train_y, test_f, test_y, *,
                     device="cuda") -> float:
    """Multinomial logistic-regression probe (features are frozen)."""
    dev = strict_f32(device)
    xtr = _tensor(train_f, dev, torch.float64)
    xte = _tensor(test_f, dev, torch.float64)
    classes, ytr = torch.unique(_tensor(train_y, dev, torch.long),
                                return_inverse=True)
    # StandardScaler: population std; a constant feature is left unscaled.
    mean = xtr.mean(dim=0)
    std = xtr.std(dim=0, unbiased=False)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    xtr, xte = (xtr - mean) / std, (xte - mean) / std
    if classes.numel() < 2:
        pred = classes.expand(xte.shape[0])
    else:
        w, b = fit_linear_probe(xtr, ytr, classes.numel())
        pred = classes[_logits(xte, w, b).argmax(dim=1)]
    return float((pred == _tensor(test_y, dev, torch.long)).double().mean())


def knn_acc(train_f, train_y, test_f, test_y, k: int = 5, *,
            device="cuda", block: int = 1024) -> float:
    """k-nearest-neighbour accuracy: L2 distances (float64, blocked over the
    test rows), uniform votes, ties to the lowest label."""
    dev = strict_f32(device)
    xtr = _tensor(train_f, dev, torch.float64)
    xte = _tensor(test_f, dev, torch.float64)
    classes, ytr = torch.unique(_tensor(train_y, dev, torch.long),
                                return_inverse=True)
    yte = _tensor(test_y, dev, torch.long)
    if k > xtr.shape[0]:
        raise ValueError(f"k={k} neighbours of {xtr.shape[0]} train samples")
    sq = (xtr * xtr).sum(dim=1)
    correct = 0
    for lo in range(0, xte.shape[0], block):
        q = xte[lo:lo + block]
        d2 = (q * q).sum(dim=1)[:, None] + sq[None, :] - 2.0 * (q @ xtr.T)
        near = torch.topk(d2, k, dim=1, largest=False).indices
        votes = F.one_hot(ytr[near], classes.numel()).sum(dim=1)
        pred = classes[votes.argmax(dim=1)]  # first maximum: lowest label
        correct += int((pred == yte[lo:lo + block]).sum())
    return correct / xte.shape[0]


def retrieval_map(feats, labels, block: int = 512, *,
                  device="cuda") -> float:
    """Leave-one-out retrieval mean average precision with L2 ranking: each
    sample queries the rest of the set; relevant = same label.

    The (block, N) distance product is f32; the cumulative-sum and precision
    arithmetic is float64, as in the JAX package."""
    dev = strict_f32(device)
    x = _tensor(feats, dev, torch.float32).contiguous()
    y = _tensor(labels, dev, torch.long)
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    ranks = torch.arange(1, n, dtype=torch.float64, device=dev)
    ap_sum = 0.0
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (x[lo:hi] @ x.T)
        d2[torch.arange(hi - lo, device=dev),
           torch.arange(lo, hi, device=dev)] = float("inf")
        order = torch.argsort(d2, dim=1, stable=True)[:, : n - 1]
        rel = y[order] == y[lo:hi, None]
        cum_rel = torch.cumsum(rel, dim=1, dtype=torch.float64)
        precision_at = cum_rel / ranks[None, :]
        n_rel = rel.sum(dim=1)
        ap = torch.where(
            n_rel > 0,
            (precision_at * rel).sum(dim=1) / torch.clamp(n_rel, min=1),
            torch.zeros((), dtype=torch.float64, device=dev))
        ap_sum += float(ap.sum())
    return ap_sum / n


def evaluate_features(
    train_feats,
    train_labels,
    test_feats,
    test_labels,
    *,
    metrics=("linear", "knn", "map"),
    knn_k: int = 5,
    probe_split: float = 0.5,
    seed: int = 0,
    device="cuda",
) -> dict[str, float]:
    """Metrics for ONE t's feature matrix.  Without a train split, probes use
    a random half/half split of the test features (deterministic in seed;
    the numpy permutation of the JAX package, so both split alike)."""
    dev = strict_f32(device)
    test_feats = _tensor(test_feats, dev, torch.float32)
    test_labels = _tensor(test_labels, dev, torch.long)
    if train_feats is None:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(test_feats))
        cut = int(len(idx) * probe_split)
        if cut < 2 or len(idx) - cut < 1:
            raise ValueError(
                f"too few samples ({len(idx)}) for a {probe_split:.0%} "
                "self-split probe — pass explicit train features or more data"
            )
        tr, te = (torch.from_numpy(i).to(dev) for i in (idx[:cut], idx[cut:]))
        train_feats, train_labels = test_feats[tr], test_labels[tr]
        test_feats_p, test_labels_p = test_feats[te], test_labels[te]
    else:
        test_feats_p, test_labels_p = test_feats, test_labels

    out = {}
    if "linear" in metrics:
        out["linear_acc"] = linear_probe_acc(
            train_feats, train_labels, test_feats_p, test_labels_p, device=dev)
    if "knn" in metrics:
        out["knn_acc"] = knn_acc(
            train_feats, train_labels, test_feats_p, test_labels_p, k=knn_k,
            device=dev)
    if "map" in metrics:
        out["retrieval_map"] = retrieval_map(test_feats, test_labels,
                                             device=dev)
    return out
