from .api import ODEBlock, ODENet, ResNet
from .common import (
    ModelConfig,
    head_apply,
    init_head,
    init_stem,
    pool_features,
    stem_apply,
)
from .odenet import (
    block_dynamics,
    check_compute_dtype,
    fused_rk_eligible,
    init_odefunc,
    init_odenet,
    odefunc_apply,
    odenet_logits,
    odenet_solve,
    odenet_trajectory,
)
from .resnet import init_resnet, resnet_block_states, resnet_logits

__all__ = [
    "ModelConfig",
    "head_apply",
    "init_head",
    "init_stem",
    "pool_features",
    "stem_apply",
    "block_dynamics",
    "check_compute_dtype",
    "fused_rk_eligible",
    "init_odefunc",
    "init_odenet",
    "odefunc_apply",
    "odenet_logits",
    "odenet_solve",
    "odenet_trajectory",
    "init_resnet",
    "resnet_block_states",
    "resnet_logits",
    "ODENet",
    "ODEBlock",
    "ResNet",
]
