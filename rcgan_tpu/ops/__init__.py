"""Op library: parameterized layer factories over a :class:`Ctx`.

Replaces the reference's L2 ops layer (``mnist/ops.py``, ``mnist/sn.py``,
``cifar10/common/ops/*``) with XLA-lowered equivalents.
"""

from rcgan_tpu.ops.conv import (
    conv2d,
    conv2d_lib,
    conv_cond_concat,
    deconv2d,
    lrelu,
    mean_pool,
    upsample_depth_to_space,
)
from rcgan_tpu.ops.linear import embed_y, linear, linear_lib
from rcgan_tpu.ops.norm import (
    batch_norm,
    cond_batchnorm,
    instance_norm,
    layer_norm,
    pixel_norm,
)
from rcgan_tpu.ops.sn import exact_sigma, spectral_normed_weight

__all__ = [
    "conv2d",
    "conv2d_lib",
    "conv_cond_concat",
    "deconv2d",
    "lrelu",
    "mean_pool",
    "upsample_depth_to_space",
    "embed_y",
    "linear",
    "linear_lib",
    "batch_norm",
    "cond_batchnorm",
    "instance_norm",
    "layer_norm",
    "pixel_norm",
    "exact_sigma",
    "spectral_normed_weight",
]
