"""Evaluate extracted features: accuracy / retrieval-mAP vs integration time
(port of the JAX CLI ``evaluate.py``).

    python -m neural_ode_features_tpu_torch.evaluate \\
        --features runs/<run>/features_test.npz \\
        --train-features runs/<run>/features_train.npz

Reads the per-t feature file(s) written by ``extract`` (``.npz`` or
``.h5``), computes linear-probe accuracy, kNN accuracy and retrieval mAP at
every t on the device (``evaluation/probes.py``; the card unless ``--cpu``),
and writes ``metrics_vs_t.csv`` next to the input: the data behind the
metric-vs-t curves.  ``--tsne`` needs scikit-learn and ``--plot`` needs
matplotlib; each is imported where it is used and is an error where missing.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from .evaluation.probes import evaluate_features
from .features_io import load_features

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--features", required=True,
                   help="test-split feature file from extract")
    p.add_argument("--train-features", default=None,
                   help="optional train-split feature file (probes train "
                        "here; default: half/half split of --features)")
    p.add_argument("--metrics", default="linear,knn,map")
    p.add_argument("--knn-k", type=int, default=5)
    p.add_argument("--limit", type=int, default=None,
                   help="subsample test features (mAP is O(N^2))")
    p.add_argument("--tsne", action="store_true",
                   help="also write 2-D t-SNE embeddings per t "
                        "(tsne_t*.csv next to the feature file)")
    p.add_argument("--plot", action="store_true",
                   help="also write metrics_vs_t.png")
    p.add_argument("--output", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="compute the metrics on the CPU")
    return p.parse_args(argv)


def _plot_metrics(rows: list[dict], out_png):
    """Metric-vs-t line chart (matplotlib, static PNG): 2px lines, small
    markers, a recessive grid, a legend and direct end labels, staggered
    where the series end close together."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series_colors = ["#2a78d6", "#eb6834", "#1baf7a"]  # blue, orange, aqua
    ink, ink2 = "#0b0b0b", "#52514e"
    surface = "#fcfcfb"
    labels = {"linear_acc": "linear probe", "knn_acc": "kNN",
              "retrieval_map": "retrieval mAP"}

    ts = [r["t"] for r in rows]
    keys = [k for k in ("linear_acc", "knn_acc", "retrieval_map")
            if k in rows[0]]

    fig, ax = plt.subplots(figsize=(6.4, 4.0), dpi=150)
    fig.patch.set_facecolor(surface)
    ax.set_facecolor(surface)
    ends = sorted(((rows[-1][k], i) for i, k in enumerate(keys)))
    label_y = {}
    prev = None
    for v, i in ends:
        y = v if prev is None else max(v, prev + 0.05)
        label_y[i] = min(y, 1.0 + 0.05 * (len(ends) - 1))
        prev = label_y[i]
    for i, k in enumerate(keys):
        vals = [r[k] for r in rows]
        ax.plot(ts, vals, color=series_colors[i], linewidth=2, marker="o",
                markersize=4.5, label=labels[k])
        ax.annotate(labels[k], (ts[-1], label_y[i]), xytext=(6, 0),
                    textcoords="offset points", va="center", fontsize=8,
                    color=ink2, annotation_clip=False)
    ax.set_xlabel("integration time t", color=ink2, fontsize=9)
    ax.set_ylabel("metric", color=ink2, fontsize=9)
    ax.set_title("Feature quality vs integration time", color=ink,
                 fontsize=11, loc="left")
    ax.set_ylim(0.0, 1.02)
    ax.grid(True, color="#e4e3df", linewidth=0.6)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color("#c3c2b7")
    ax.tick_params(colors=ink2, labelsize=8)
    if len(keys) >= 2:
        ax.legend(frameon=False, fontsize=8, labelcolor=ink2,
                  loc="lower right")
    fig.tight_layout()
    fig.savefig(out_png, facecolor=surface, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> Path:
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    test = load_features(args.features)
    ts, feats, labels = test["t"], test["features"], test["labels"]

    train = None
    if args.train_features:
        tr = load_features(args.train_features)
        train = (tr["features"], tr["labels"])
        # The probe pairs train/test features BY INDEX, so the two files
        # must have been extracted on the same t-grid; otherwise every
        # t > 0 row would train on one time and test on another.
        if tr["t"].shape != ts.shape or not np.allclose(tr["t"], ts,
                                                        atol=1e-6):
            raise SystemExit(
                f"--train-features t-grid {np.round(tr['t'], 4).tolist()} "
                f"!= --features t-grid {np.round(ts, 4).tolist()}: re-run "
                "extract with the same --timestamps for both splits")

    if args.limit and args.limit < feats.shape[1]:
        rng = np.random.default_rng(0)
        sel = rng.permutation(feats.shape[1])[: args.limit]
        feats, labels = feats[:, sel], labels[sel]

    metrics = tuple(m.strip() for m in args.metrics.split(","))
    unknown = [m for m in metrics if m not in ("linear", "knn", "map")]
    if unknown:
        raise SystemExit(
            f"--metrics {args.metrics}: unknown metric(s) {unknown}; "
            "valid tokens are linear (linear probe), knn, map")
    rows = []
    for i, t in enumerate(ts):
        tf, tl = (train[0][i], train[1]) if train else (None, None)
        m = evaluate_features(tf, tl, feats[i], labels, metrics=metrics,
                              knn_k=args.knn_k, device=device)
        rows.append({"t": round(float(t), 4),
                     **{k: round(v, 4) for k, v in m.items()}})
        print(" | ".join(f"{k}={v}" for k, v in rows[-1].items()), flush=True)
        if args.tsne:
            from sklearn.manifold import TSNE

            emb = TSNE(n_components=2, init="pca", random_state=0,
                       perplexity=min(30, max(5, len(labels) // 20))
                       ).fit_transform(feats[i])
            out_t = Path(args.features).with_name(f"tsne_t{float(t):.2f}.csv")
            np.savetxt(out_t, np.column_stack([emb, labels]),
                       delimiter=",", header="x,y,label", comments="")
            print(f"  wrote {out_t}")

    out = Path(args.output) if args.output else (
        Path(args.features).with_name("metrics_vs_t.csv"))
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out}")

    if args.plot:
        out_png = out.with_suffix(".png")
        _plot_metrics(rows, out_png)
        print(f"wrote {out_png}")

    def _score(r):
        # First metric that was actually computed (with --metrics map only,
        # keying on linear_acc would make every row score 0).
        for k in ("linear_acc", "knn_acc", "retrieval_map"):
            if k in r:
                return r[k]
        return 0.0

    best = max(rows, key=_score)
    print(f"best t: {best}")
    return out


if __name__ == "__main__":
    main()
