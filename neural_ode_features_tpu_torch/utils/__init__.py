from .checkpoint import from_jax_params, from_torch_state_dict, to_torch_state_dict
from .meters import AverageMeter, RunningAverageMeter, count_parameters

__all__ = ["from_jax_params", "from_torch_state_dict", "to_torch_state_dict",
           "AverageMeter", "RunningAverageMeter", "count_parameters"]
