from .layers import (
    concat_conv2d,
    concat_time_channel,
    conv2d,
    global_avg_pool,
    group_norm,
    init_conv,
    init_group_norm,
    init_linear,
    linear,
    time_map,
)
from .preprocess import (
    NORM_STATS,
    augment,
    crop_and_flip,
    normalize,
    normalized_black,
)

__all__ = [
    "concat_conv2d",
    "concat_time_channel",
    "conv2d",
    "global_avg_pool",
    "group_norm",
    "init_conv",
    "init_group_norm",
    "init_linear",
    "linear",
    "time_map",
    "NORM_STATS",
    "augment",
    "crop_and_flip",
    "normalize",
    "normalized_black",
]
