from .checkpoint import (
    from_jax_params,
    from_torch_state_dict,
    load_checkpoint,
    resolve_checkpoint,
    save_checkpoint,
    to_torch_state_dict,
)
from .expman import Experiment
from .flops import (
    odenet_flops_per_image,
    odenet_train_flops_per_image,
    peak_flops_per_chip,
)
from .meters import AverageMeter, RunningAverageMeter, count_parameters

__all__ = ["from_jax_params", "from_torch_state_dict", "to_torch_state_dict",
           "save_checkpoint", "load_checkpoint", "resolve_checkpoint",
           "Experiment", "AverageMeter", "RunningAverageMeter", "count_parameters",
           "odenet_flops_per_image", "odenet_train_flops_per_image",
           "peak_flops_per_chip"]
