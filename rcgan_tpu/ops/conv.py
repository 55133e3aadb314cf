"""Convolution ops (NHWC), lowered to XLA ``conv_general_dilated``.

Variants mirror the two reference stacks:
  * :func:`conv2d` / :func:`deconv2d` — DCGAN 5x5/s2 conv and
    conv2d_transpose (``mnist/ops.py:53-92``).
  * :func:`conv2d_lib` — GAN_Lib conv with he/Glorot uniform init, optional
    spectral norm, PixelCNN masks, depthwise/separable variants
    (``cifar10/common/ops/conv2d.py:31-218``).
  * Resample helpers used by the ResNet blocks: :func:`mean_pool`,
    :func:`upsample_depth_to_space` (``cifar10/gan_resnet.py:231-272``).

All convs compute in ``ctx.compute_dtype`` with float32 accumulation.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu.core import initializers as inits
from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops.sn import spectral_normed_weight

_DIMS = ("NHWC", "HWIO", "NHWC")


@jax.named_scope("conv")
def _conv(x, w, stride, padding, compute_dtype, feature_group_count=1):
    # Inputs cast to the compute dtype; cuDNN accumulates bf16 convolutions
    # in float32, so no preferred_element_type is needed (and its VJP
    # rejects mixed f32 cotangents in this JAX version).
    return jax.lax.conv_general_dilated(
        x.astype(compute_dtype),
        w.astype(compute_dtype),
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=_DIMS,
        feature_group_count=feature_group_count,
    )


def conv2d(
    ctx: Ctx,
    x: jax.Array,
    output_dim: int,
    name: str,
    k: int = 5,
    stride: int = 2,
    stddev: float = 0.02,
    spectral_norm: bool = False,
):
    """DCGAN conv: 5x5 stride-2 SAME, truncated-normal(0.02) filters, bias."""
    cin = x.shape[-1]
    w = ctx.param(name, "w", (k, k, cin, output_dim), inits.truncated_normal(stddev))
    if spectral_norm:
        w = spectral_normed_weight(ctx, name, w)
    b = ctx.param(name, "biases", (output_dim,), inits.zeros)
    out = _conv(x, w, stride, "SAME", ctx.compute_dtype)
    return out + b.astype(out.dtype)


def deconv2d(
    ctx: Ctx,
    x: jax.Array,
    output_dim: int,
    name: str,
    k: int = 5,
    stride: int = 2,
    stddev: float = 0.02,
):
    """DCGAN conv2d_transpose: SAME padding, stride 2, normal(0.02) filters.

    The filter is stored in TF layout ``[k, k, cout, cin]``
    (``mnist/ops.py:74``) and applied as the transpose (gradient) of a
    forward conv, which XLA lowers to an input-dilated conv.
    """
    cin = x.shape[-1]
    w = ctx.param(name, "w", (k, k, output_dim, cin), inits.normal(stddev))
    b = ctx.param(name, "biases", (output_dim,), inits.zeros)
    out = jax.lax.conv_transpose(
        x.astype(ctx.compute_dtype),
        w.astype(ctx.compute_dtype),
        strides=(stride, stride),
        padding="SAME",
        dimension_numbers=_DIMS,
        transpose_kernel=True,
    )
    return out + b.astype(out.dtype)


def conv2d_lib(
    ctx: Ctx,
    x: jax.Array,
    input_dim: int,
    output_dim: int,
    filter_size: int = 3,
    stride: int = 1,
    name: str = "Conv2D",
    conv_type: str = "conv2d",
    channel_multiplier: int = 0,
    padding: str = "SAME",
    spectral_normed: bool = False,
    he_init: bool = True,
    mask_type=None,
    weightnorm: bool = False,
    biases: bool = True,
    gain: float = 1.0,
):
    """GAN_Lib Conv2D.  ``mask_type``: None or ('a'|'b', n_channels) for
    PixelCNN-style causal masks (``conv2d.py:63-81``).  ``weightnorm``
    reparameterizes the filter as ``W * g / ||W||`` with the per-output-channel
    norm over (h, w, cin) and a trainable ``g`` initialized to the init-time
    filter norms (``conv2d.py:152-162``); applied before mask/SN, matching the
    reference order."""
    init = inits.conv_uniform(stride=stride, he=he_init, gain=gain)
    if conv_type == "conv2d":
        w = ctx.param(name, "Filters", (filter_size, filter_size, input_dim, output_dim), init)
        if weightnorm:
            w = _weightnormed(ctx, name, w, axes=(0, 1, 2))
        if mask_type is not None:
            w = w * jnp.asarray(_pixelcnn_mask(mask_type, filter_size, input_dim, output_dim))
        if spectral_normed:
            w = spectral_normed_weight(ctx, name, w)
        out = _conv(x, w, stride, padding, ctx.compute_dtype)
    elif conv_type == "depthwise_conv2d":
        assert channel_multiplier > 0
        dw = ctx.param(
            name, "depthwise_filters", (filter_size, filter_size, input_dim, channel_multiplier), init
        )
        if spectral_normed:
            dw = spectral_normed_weight(ctx, name + ".dw", dw)
        out = _depthwise(x, dw, stride, padding, ctx.compute_dtype)
        output_dim = input_dim * channel_multiplier
    elif conv_type == "separable_conv2d":
        assert channel_multiplier > 0
        dw = ctx.param(
            name, "depthwise_filters", (filter_size, filter_size, input_dim, channel_multiplier), init
        )
        pw = ctx.param(name, "pointwise_filters", (1, 1, input_dim * channel_multiplier, output_dim), init)
        if spectral_normed:
            dw = spectral_normed_weight(ctx, name + ".dw", dw)
            pw = spectral_normed_weight(ctx, name + ".pw", pw)
        out = _depthwise(x, dw, stride, padding, ctx.compute_dtype)
        out = _conv(out, pw, 1, "SAME", ctx.compute_dtype)
    else:
        raise NotImplementedError(conv_type)

    if biases:
        b = ctx.param(name, "Biases", (output_dim,), inits.zeros)
        out = out + b.astype(out.dtype)
    return out


def _weightnormed(ctx: Ctx, name: str, w: jax.Array, axes) -> jax.Array:
    """Weight-norm reparameterization ``W * g / ||W||``
    (``cifar10/common/ops/conv2d.py:152-162``, ``linear.py:143-155``).

    ``g`` is a trainable per-output-channel scale whose initial value is the
    L2 norm of the INITIAL weights over ``axes`` — at init time ``w`` IS the
    initial value, so the init closure computes it directly."""
    g = ctx.param(
        name, "g", (w.shape[-1],),
        lambda key, shape, dtype: jnp.sqrt(jnp.sum(jnp.square(w), axis=axes)).astype(dtype),
    )
    norms = jnp.sqrt(jnp.sum(jnp.square(w), axis=axes))
    return w * (g / norms)


def _depthwise(x, dw, stride, padding, compute_dtype):
    k, _, cin, mult = dw.shape
    w = dw.transpose(0, 1, 3, 2).reshape(k, k, 1, cin * mult)
    return _conv(x, w, stride, padding, compute_dtype, feature_group_count=cin)


def _pixelcnn_mask(mask_type, filter_size, input_dim, output_dim):
    mask_type, n = mask_type
    mask = np.ones((filter_size, filter_size, input_dim, output_dim), np.float32)
    c = filter_size // 2
    mask[c + 1 :, :, :, :] = 0.0
    mask[c, c + 1 :, :, :] = 0.0
    for i in range(n):
        for j in range(n):
            if (mask_type == "a" and i >= j) or (mask_type == "b" and i > j):
                mask[c, c, i::n, j::n] = 0.0
    return mask


def conv1d_lib(
    ctx: Ctx,
    x: jax.Array,
    input_dim: int,
    output_dim: int,
    filter_size: int = 3,
    stride: int = 1,
    name: str = "Conv1D",
    padding: str = "SAME",
    mask_type=None,
    spectral_normed: bool = False,
    he_init: bool = True,
    biases: bool = True,
    gain: float = 1.0,
):
    """1-D conv with the optional causal PixelCNN-style mask
    (``cifar10/common/ops/conv1d.py:16-116``).  ``x``: [B, W, C]."""
    init = inits.conv_uniform(stride=stride, he=he_init, gain=gain)

    def init1d(key, shape, dtype):
        k, cin, cout = shape
        w = init(key, (1, k, cin, cout), dtype)
        return w[0]

    w = ctx.param(name, "Filters", (filter_size, input_dim, output_dim), init1d)
    if mask_type is not None:
        mtype, n = mask_type
        mask = np.ones((filter_size, input_dim, output_dim), np.float32)
        c = filter_size // 2
        mask[c + 1 :, :, :] = 0.0
        for i in range(n):
            for j in range(n):
                if (mtype == "a" and i >= j) or (mtype == "b" and i > j):
                    mask[c, i::n, j::n] = 0.0
        w = w * jnp.asarray(mask)
    if spectral_normed:
        w = spectral_normed_weight(ctx, name, w)
    out = jax.lax.conv_general_dilated(
        x.astype(ctx.compute_dtype),
        w.astype(ctx.compute_dtype),
        window_strides=(stride,),
        padding=padding,
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    if biases:
        b = ctx.param(name, "Biases", (output_dim,), inits.zeros)
        out = out + b.astype(out.dtype)
    return out


def conv_cond_concat(x: jax.Array, y: jax.Array) -> jax.Array:
    """Concat a per-example label vector onto every spatial position
    (``mnist/ops.py:46-51``).  ``y`` is ``[B, y_dim]`` or ``[B,1,1,y_dim]``."""
    if y.ndim == 2:
        y = y[:, None, None, :]
    b, h, w, _ = x.shape
    y = jnp.broadcast_to(y, (b, h, w, y.shape[-1])).astype(x.dtype)
    return jnp.concatenate([x, y], axis=3)


def mean_pool(x: jax.Array) -> jax.Array:
    """2x2 mean pool via the reference's 4-phase slicing
    (``cifar10/gan_resnet.py:239-240``)."""
    return (x[:, ::2, ::2, :] + x[:, 1::2, ::2, :] + x[:, ::2, 1::2, :] + x[:, 1::2, 1::2, :]) / 4.0


def upsample_depth_to_space(x: jax.Array) -> jax.Array:
    """2x nearest-neighbor upsample: channel-concat x4 then depth_to_space
    (``cifar10/gan_resnet.py:263-264``), as reshape/transpose for XLA."""
    b, h, w, c = x.shape
    y = jnp.concatenate([x, x, x, x], axis=3)
    # depth_to_space(block=2), NHWC: [B,H,W,4C] -> [B,2H,2W,C]
    y = y.reshape(b, h, w, 2, 2, c)
    y = y.transpose(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * 2, w * 2, c)


def lrelu(x: jax.Array, leak: float = 0.2) -> jax.Array:
    return jnp.maximum(x, leak * x)
