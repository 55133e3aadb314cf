"""Normalization layers with the reference's exact (and divergent) semantics.

Two different batch-norm behaviors must coexist (SURVEY §7 risk register):
  * :func:`batch_norm` — standard BN with moving statistics; train mode uses
    batch moments and updates the EMAs, eval mode uses the EMAs
    (``mnist/ops.py:30-44``; ``cifar10/common/ops/normalization.py:8-24``
    adds ``zero_debias_moving_mean=True``).
  * :func:`cond_batchnorm` — conditional BN that uses **batch statistics
    only, even at sample time** — it keeps no moving averages
    (``cifar10/common/ops/normalization.py:27-59``).  Per-class scale/offset
    come from ``[n_labels, C]`` embedding tables.

Moments are computed in float32 regardless of compute dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rcgan_tpu.core import initializers as inits
from rcgan_tpu.core.module import Ctx


def _moments(x: jax.Array, axes) -> tuple[jax.Array, jax.Array]:
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=axes, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=axes, keepdims=True)
    return mean, var


def batch_norm(
    ctx: Ctx,
    x: jax.Array,
    name: str,
    train: bool | None = None,
    decay: float = 0.9,
    epsilon: float = 1e-5,
    zero_debias: bool = False,
):
    """BN over all axes but the last.  ``train=None`` uses ``ctx.train``.

    ``zero_debias`` implements TF's ``zero_debias_moving_mean``: the moving
    mean is stored as a biased accumulator plus an update counter and
    debiased by ``1 - decay**t`` on read.
    """
    if train is None:
        train = ctx.train
    c = x.shape[-1]
    axes = tuple(range(x.ndim - 1))

    scale = ctx.param(name, "gamma", (c,), inits.ones)
    offset = ctx.param(name, "beta", (c,), inits.zeros)
    moving_mean = ctx.stat(name, "moving_mean", (c,), inits.zeros)
    moving_var = ctx.stat(name, "moving_variance", (c,), inits.ones)

    if train:
        mean, var = _moments(x, axes)
        mean_v = mean.reshape(c)
        var_v = var.reshape(c)
        if zero_debias:
            biased = ctx.stat(name, "biased_mean", (c,), inits.zeros)
            local_step = ctx.stat(name, "local_step", (1,), inits.zeros)
            biased = decay * biased + (1.0 - decay) * mean_v
            local_step = local_step + 1.0
            debias = 1.0 - decay ** local_step[0]
            new_moving_mean = biased / jnp.maximum(debias, 1e-12)
            ctx.put_stat(name, "biased_mean", jax.lax.stop_gradient(biased))
            ctx.put_stat(name, "local_step", jax.lax.stop_gradient(local_step))
        else:
            new_moving_mean = decay * moving_mean + (1.0 - decay) * mean_v
        new_moving_var = decay * moving_var + (1.0 - decay) * var_v
        ctx.put_stat(name, "moving_mean", jax.lax.stop_gradient(new_moving_mean))
        ctx.put_stat(name, "moving_variance", jax.lax.stop_gradient(new_moving_var))
    else:
        mean = moving_mean.reshape((1,) * (x.ndim - 1) + (c,))
        var = moving_var.reshape((1,) * (x.ndim - 1) + (c,))

    x32 = x.astype(jnp.float32)
    inv = jax.lax.rsqrt(var + epsilon) * scale
    out = (x32 - mean) * inv + offset
    return out.astype(x.dtype)


@jax.named_scope("cond_bn")
def cond_batchnorm(
    ctx: Ctx,
    x: jax.Array,
    labels: jax.Array,
    n_labels: int,
    name: str,
    epsilon: float = 1e-5,
):
    """Conditional BN (Dumoulin et al.): batch moments over (0,1,2), per-class
    scale/offset looked up by integer label.  No moving averages by design —
    do NOT "fix" this or CIFAR sampling behavior diverges from the reference
    (``normalization.py:47-58``)."""
    assert x.ndim == 4, "cond_batchnorm expects BHWC"
    c = x.shape[-1]
    offset_m = ctx.param(name, "offset", (n_labels, c), inits.zeros)
    scale_m = ctx.param(name, "scale", (n_labels, c), inits.ones)
    offset = jnp.take(offset_m, labels, axis=0)[:, None, None, :]
    scale = jnp.take(scale_m, labels, axis=0)[:, None, None, :]

    mean, var = _moments(x, (0, 1, 2))
    x32 = x.astype(jnp.float32)
    out = (x32 - mean) * jax.lax.rsqrt(var + epsilon) * scale + offset
    return out.astype(x.dtype)


def layer_norm(ctx: Ctx, x: jax.Array, name: str, epsilon: float = 1e-12):
    """Layer norm over all non-batch dims; per-channel scale/offset
    (contrib defaults: begin_norm_axis=1, begin_params_axis=-1)."""
    c = x.shape[-1]
    scale = ctx.param(name, "gamma", (c,), inits.ones)
    offset = ctx.param(name, "beta", (c,), inits.zeros)
    axes = tuple(range(1, x.ndim))
    mean, var = _moments(x, axes)
    x32 = x.astype(jnp.float32)
    out = (x32 - mean) * jax.lax.rsqrt(var + epsilon) * scale + offset
    return out.astype(x.dtype)


def instance_norm(ctx: Ctx, x: jax.Array, name: str, epsilon: float = 1e-6):
    """Per-example, per-channel spatial normalization (NHWC)."""
    c = x.shape[-1]
    scale = ctx.param(name, "gamma", (c,), inits.ones)
    offset = ctx.param(name, "beta", (c,), inits.zeros)
    mean, var = _moments(x, (1, 2))
    x32 = x.astype(jnp.float32)
    out = (x32 - mean) * jax.lax.rsqrt(var + epsilon) * scale + offset
    return out.astype(x.dtype)


def pixel_norm(x: jax.Array, eps: float = 1e-8):
    """PGGAN pixelwise feature normalization (``normalization.py:125-140``)."""
    x32 = x.astype(jnp.float32)
    alpha = jax.lax.rsqrt(jnp.mean(x32 * x32, axis=3, keepdims=True) + eps)
    return (x32 * alpha).astype(x.dtype)
