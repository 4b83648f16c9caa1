from .common import (
    ModelConfig,
    head_apply,
    init_head,
    init_stem,
    pool_features,
    stem_apply,
)
from .odenet import (
    fused_rk_eligible,
    init_odefunc,
    init_odenet,
    odefunc_apply,
    odenet_logits,
)

__all__ = [
    "ModelConfig",
    "head_apply",
    "init_head",
    "init_stem",
    "pool_features",
    "stem_apply",
    "fused_rk_eligible",
    "init_odefunc",
    "init_odenet",
    "odefunc_apply",
    "odenet_logits",
]
