"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and no CUDA
    device is present.  There is no silent CPU fallback: the CPU runs only
    when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def strict_f32(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device`` and turn TF32 off in cuDNN convs and cuBLAS
    matmuls: TF32 is the H100 twin of the TPU's bf16 default, which the JAX
    package had to pin away from its solver-side contractions."""
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def tree_to(tree, dev: torch.device):
    """A param tree (dicts, lists and tuples of tensors) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)
