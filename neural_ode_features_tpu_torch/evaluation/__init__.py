from .probes import evaluate_features, knn_acc, linear_probe_acc, retrieval_map

__all__ = ["evaluate_features", "knn_acc", "linear_probe_acc", "retrieval_map"]
