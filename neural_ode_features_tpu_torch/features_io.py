"""The per-t feature file that ``extract`` writes and ``evaluate`` reads.

Layout (the JAX ``extract.py``'s):

    /t            (T,)  float32 — integration times
    /features     (T, N, C) float32 — per-t feature matrices
    /labels       (N,) int32
    /nfe          (N,) int32 — per-sample NFE of the extraction solve
    attributes    dataset (str), model (str), tol (float)

The suffix picks the container.  ``.h5``: HDF5 through ``h5py``, the JAX
CLI's format; ``h5py`` is imported here and required (a missing ``h5py`` is
an error, not a switch to another format).  ``.npz``: numpy's archive, with
the same keys and the attributes as 0-d arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["save_features", "load_features"]

_ARRAYS = (("t", np.float32), ("features", np.float32), ("labels", np.int32),
           ("nfe", np.int32))


def _suffix(path: Path) -> str:
    if path.suffix not in (".h5", ".npz"):
        raise ValueError(f"{path}: the feature file is .h5 or .npz")
    return path.suffix


def save_features(path, *, t, features, labels, nfe, dataset: str,
                  model: str, tol: float) -> Path:
    """Write one feature file; returns its path."""
    path = Path(path)
    given = dict(t=t, features=features, labels=labels, nfe=nfe)
    arrays = {k: np.ascontiguousarray(given[k], dtype) for k, dtype in _ARRAYS}
    n_t, n = arrays["features"].shape[:2]
    if (arrays["t"].shape != (n_t,) or arrays["labels"].shape != (n,)
            or arrays["nfe"].shape != (n,)):
        raise ValueError(
            "feature file shapes disagree: "
            f"{ {k: v.shape for k, v in arrays.items()} }")
    if _suffix(path) == ".h5":
        import h5py

        with h5py.File(path, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v)
            f.attrs["dataset"] = dataset
            f.attrs["model"] = model
            f.attrs["tol"] = tol
    else:
        with open(path, "wb") as f:
            np.savez(f, **arrays, dataset=np.array(dataset),
                     model=np.array(model), tol=np.array(float(tol)))
    return path


def load_features(path) -> dict:
    """Read a feature file: ``t``, ``features``, ``labels``, ``nfe`` (numpy)
    and ``attrs`` (``dataset``, ``model``, ``tol``; those the file has)."""
    path = Path(path)
    names = [k for k, _ in _ARRAYS]
    if _suffix(path) == ".h5":
        import h5py

        with h5py.File(path) as f:
            out = {k: np.asarray(f[k]) for k in names if k in f}
            attrs = {k: (v.decode() if isinstance(v, bytes) else
                         v.item() if isinstance(v, np.generic) else v)
                     for k, v in f.attrs.items()}
    else:
        with np.load(path, allow_pickle=False) as f:
            out = {k: f[k] for k in names if k in f.files}
            attrs = {k: f[k].item() for k in ("dataset", "model", "tol")
                     if k in f.files}
    out["attrs"] = attrs
    return out
