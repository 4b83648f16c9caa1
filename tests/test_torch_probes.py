"""Port parity: ``evaluation/probes.py`` (the metrics computed on tensors)
against the JAX package's scikit-learn ones on seeded features: retrieval
mAP at 1e-6, kNN equal to the last sample, the linear probe within 2 samples
of the test half (L-BFGS here and scikit-learn's lbfgs reach the same
optimum of a convex problem, not the same bits)."""

import numpy as np
import pytest
import torch

from neural_ode_features_tpu.evaluation import probes as jax_probes
from neural_ode_features_tpu_torch.evaluation import (
    evaluate_features,
    knn_acc,
    linear_probe_acc,
    retrieval_map,
)
from neural_ode_features_tpu_torch.evaluation.probes import fit_linear_probe

torch.set_num_threads(2)


def _features(seed, n=300, c=16, k=10, noise=1.5):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, c))
    labels = rng.integers(0, k, n).astype(np.int32)
    feats = (centres[labels] + noise * rng.normal(size=(n, c))).astype(
        np.float32)
    return feats, labels


@pytest.mark.parametrize("seed,noise", [(0, 1.5), (1, 0.8), (2, 3.0)])
def test_evaluate_features_matches_jax(seed, noise):
    feats, labels = _features(seed, noise=noise)
    want = jax_probes.evaluate_features(None, None, feats, labels)
    got = evaluate_features(None, None, feats, labels, device="cpu")
    assert list(got) == list(want) == ["linear_acc", "knn_acc",
                                       "retrieval_map"]
    assert got["retrieval_map"] == pytest.approx(want["retrieval_map"],
                                                 abs=1e-6)
    assert got["knn_acc"] == want["knn_acc"]
    assert abs(got["linear_acc"] - want["linear_acc"]) <= 2 / 150 + 1e-12
    assert all(isinstance(v, float) for v in got.values())


def test_explicit_train_split_and_options_match_jax():
    train_f, train_y = _features(3, n=240)
    test_f, test_y = _features(3, n=90)  # the same centres, fewer samples
    want = jax_probes.evaluate_features(train_f, train_y, test_f, test_y,
                                        metrics=("knn", "map"), knn_k=3)
    got = evaluate_features(torch.from_numpy(train_f),
                            torch.from_numpy(train_y), test_f, test_y,
                            metrics=("knn", "map"), knn_k=3, device="cpu")
    assert list(got) == ["knn_acc", "retrieval_map"]
    assert got["knn_acc"] == want["knn_acc"]
    assert got["retrieval_map"] == pytest.approx(want["retrieval_map"],
                                                 abs=1e-6)
    # Another seed is another split, the same one in both packages.
    a = evaluate_features(None, None, test_f, test_y, metrics=("knn",),
                          seed=5, device="cpu")
    b = jax_probes.evaluate_features(None, None, test_f, test_y,
                                     metrics=("knn",), seed=5)
    assert a == b


@pytest.mark.parametrize("block", [7, 64, 512])
def test_retrieval_map_blocks_and_matches_jax(block):
    feats, labels = _features(4, n=130)
    want = jax_probes.retrieval_map(feats, labels)
    assert retrieval_map(feats, labels, block=block,
                         device="cpu") == pytest.approx(want, abs=1e-6)


def test_retrieval_map_by_hand():
    """Queries 0 and 1 find their label at ranks 1 and 3, query 3 at ranks 2
    and 3; labels 1 and 7 have no second sample and score 0."""
    feats = np.array([[0.0], [1.0], [2.5], [4.5], [100.0]], np.float32)
    labels = np.array([0, 0, 1, 0, 7])
    per_query = [(1 + 2 / 3) / 2, (1 + 2 / 3) / 2, 0.0, (1 / 2 + 2 / 3) / 2,
                 0.0]
    got = retrieval_map(feats, labels, device="cpu")
    assert got == pytest.approx(sum(per_query) / 5, abs=1e-12)
    assert got == pytest.approx(jax_probes.retrieval_map(feats, labels),
                                abs=1e-12)


def test_knn_tie_goes_to_the_lowest_label():
    """k = 4 with two votes each for labels 3 and 1: scikit-learn answers
    the lowest label, and so does the port; k = 3 breaks the tie."""
    train_f = np.array([[1.0, 0], [-1.0, 0], [0, 1.1], [0, -1.1], [9, 9]],
                       np.float32)
    train_y = np.array([3, 3, 1, 1, 5])
    test_f = np.zeros((1, 2), np.float32)
    for k, answer in ((4, 1), (3, 3)):
        for label in (answer, 5):
            want = jax_probes.knn_acc(train_f, train_y, test_f,
                                      np.array([label]), k=k)
            got = knn_acc(train_f, train_y, test_f, np.array([label]), k=k,
                          device="cpu")
            assert got == want == float(label == answer)
    with pytest.raises(ValueError, match="neighbours"):
        knn_acc(train_f, train_y, test_f, np.array([1]), k=6, device="cpu")


def test_knn_blocks_over_test_rows():
    train_f, train_y = _features(6, n=200)
    test_f, test_y = _features(6, n=70)
    want = jax_probes.knn_acc(train_f, train_y, test_f, test_y)
    for block in (16, 1024):
        assert knn_acc(train_f, train_y, test_f, test_y, block=block,
                       device="cpu") == want


@pytest.mark.parametrize("n_classes", [10, 2])
def test_linear_probe_reaches_sklearn_optimum(n_classes):
    from sklearn.linear_model import LogisticRegression
    from sklearn.preprocessing import StandardScaler

    feats, labels = _features(7, n=260, k=n_classes)
    train_f, train_y, test_f, test_y = (feats[:160], labels[:160],
                                        feats[160:], labels[160:])
    want = jax_probes.linear_probe_acc(train_f, train_y, test_f, test_y)
    got = linear_probe_acc(train_f, train_y, test_f, test_y, device="cpu")
    assert abs(got - want) <= 2 / 100 + 1e-12

    scaler = StandardScaler().fit(train_f)
    x = scaler.transform(train_f).astype(np.float64)
    clf = LogisticRegression(max_iter=2000, C=1.0, tol=1e-8).fit(x, train_y)
    w, b = fit_linear_probe(torch.from_numpy(x),
                            torch.from_numpy(train_y.astype(np.int64)),
                            n_classes)
    assert w.dtype == torch.float64 and w.shape == clf.coef_.shape
    np.testing.assert_allclose(w.numpy(), clf.coef_, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(b.numpy(), clf.intercept_, rtol=1e-2,
                               atol=1e-3)


def test_linear_probe_constant_feature_and_label_values():
    """A constant feature is left unscaled (no 0/0), and labels need not be
    0..K-1."""
    feats, labels = _features(8, n=200, k=3)
    feats[:, 0] = 2.0
    labels = labels * 10 + 4
    want = jax_probes.linear_probe_acc(feats[:120], labels[:120], feats[120:],
                                       labels[120:])
    got = linear_probe_acc(feats[:120], labels[:120], feats[120:],
                           labels[120:], device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 2 / 80 + 1e-12


def test_too_few_samples_for_a_self_split():
    feats, labels = _features(9, n=3)
    with pytest.raises(ValueError, match="too few samples"):
        evaluate_features(None, None, feats, labels, device="cpu")
