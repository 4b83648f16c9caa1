"""State ⇄ flat-matrix conversion for the solver core (port of
``neural_ode_features_tpu/solver/ravel.py``).

A state is a tensor or a tuple, list or dict of tensors (dict leaves in
key order, as JAX flattens them).  The integrator works on one dense
``(B, N)`` matrix — one row per independently controlled sample.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable

import torch

__all__ = ["ravel_batched", "ravel_full"]


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    raise TypeError(f"unsupported state node {type(tree).__name__}")


def _build(node: Any, it) -> Any:
    if isinstance(node, torch.Tensor):
        return next(it)
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return type(node)(_build(v, it) for v in node)


def _unflatten(like: Any, leaves: list[torch.Tensor]) -> Any:
    # Not a recursive closure: that would be a reference cycle holding the
    # leaves (a solve's whole trajectory) until the cyclic collector runs.
    return _build(like, iter(leaves))


def _float_dtype(leaves: list[torch.Tensor]) -> torch.dtype:
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    if not dtype.is_floating_point:
        raise ValueError(f"state must be floating point, got {dtype}")
    return dtype


def _splitter(tree, shapes, splits):
    def unravel(mat: torch.Tensor) -> Any:
        lead = mat.shape[:-1]
        parts = torch.tensor_split(mat, splits, dim=-1)
        return _unflatten(tree, [p.reshape((*lead, *s))
                                 for p, s in zip(parts, shapes, strict=True)])
    return unravel


def ravel_batched(tree: Any) -> tuple[
        torch.Tensor, Callable[[torch.Tensor], Any], Callable[[Any], torch.Tensor]]:
    """Flatten a state whose leaves share a leading batch axis to ``(B, N)``.

    Returns ``(flat, unravel, flatten)``: ``unravel`` accepts ``(..., B, N)``
    and keeps the extra leading axes; ``flatten`` maps a same-structure state
    back to ``(B, N)``."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("empty state")
    batch = leaves[0].shape[0] if leaves[0].ndim else None
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != batch:
            raise ValueError(
                "per-sample error control requires every state leaf to have a "
                f"common leading batch axis; got shapes "
                f"{[tuple(l.shape) for l in leaves]}")
    dtype = _float_dtype(leaves)
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    splits = list(itertools.accumulate(math.prod(s) for s in shapes))[:-1]

    def flatten(t: Any) -> torch.Tensor:
        return torch.cat([l.to(dtype).reshape(batch, -1) for l in _leaves(t)],
                         dim=1)

    return flatten(tree), _splitter(tree, shapes, splits), flatten


def ravel_full(tree: Any) -> tuple[
        torch.Tensor, Callable[[torch.Tensor], Any], Callable[[Any], torch.Tensor]]:
    """Flatten any state to a single ``(1, N)`` row (batch-global error
    control); ``unravel`` accepts ``(..., 1, N)``."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("empty state")
    dtype = _float_dtype(leaves)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    splits = list(itertools.accumulate(math.prod(s) for s in shapes))[:-1]

    def flatten(t: Any) -> torch.Tensor:
        return torch.cat([l.to(dtype).reshape(-1) for l in _leaves(t)]
                         ).reshape(1, -1)

    split = _splitter(tree, shapes, splits)

    def unravel(mat: torch.Tensor) -> Any:
        return split(mat[..., 0, :])

    return flatten(tree), unravel, flatten
