"""Dense layers.

Two variants, matching the two reference stacks:
  * :func:`linear` — DCGAN-style, normal(0.02) init, optional unit-clip
    max-norm constraint (``mnist/ops.py:97-116``).
  * :func:`linear_lib` — GAN_Lib-style with the init zoo, optional spectral
    norm / weight norm and >2D reshape handling
    (``cifar10/common/ops/linear.py:38-182``).

Matmuls run in ``ctx.compute_dtype`` with float32 accumulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rcgan_tpu.core import initializers as inits
from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops.sn import spectral_normed_weight


def _matmul(x: jax.Array, w: jax.Array, compute_dtype) -> jax.Array:
    # bf16 x bf16 dots accumulate in f32 on the tensor cores; output stays in the
    # compute dtype and is cast to f32 at loss/norm boundaries.
    x = x.astype(compute_dtype)
    w = w.astype(compute_dtype)
    return jnp.dot(x, w)


def linear(
    ctx: Ctx,
    x: jax.Array,
    output_size: int,
    name: str,
    stddev: float = 0.02,
    bias_start: float = 0.0,
    max_norm: bool = False,
):
    """DCGAN linear.  ``max_norm`` registers a [-1, 1] clip constraint that the
    optimizer applies post-update (TF ``constraint=`` semantics)."""
    in_dim = x.shape[-1]
    w = ctx.param(name, "Matrix", (in_dim, output_size), inits.normal(stddev))
    b = ctx.param(name, "bias", (output_size,), inits.constant(bias_start))
    if max_norm and ctx.init:
        ctx.constraints.setdefault(name, {})["Matrix"] = (-1.0, 1.0)
        ctx.constraints.setdefault(name, {})["bias"] = (-1.0, 1.0)
    out = _matmul(x, w, ctx.compute_dtype)
    return out + b.astype(out.dtype)


def linear_lib(
    ctx: Ctx,
    x: jax.Array,
    input_dim: int,
    output_dim: int,
    name: str,
    spectral_normed: bool = False,
    weightnorm: bool = False,
    biases: bool = True,
    initialization=None,
    gain: float = 1.0,
):
    """GAN_Lib Linear with init zoo + optional SN / weight norm.  Handles >2D
    inputs by flattening leading dims (``linear.py:162-174``).  ``weightnorm``
    reparameterizes ``W`` as ``W * g / ||W||`` with per-output-column norms and
    trainable ``g`` initialized to the init-time norms (``linear.py:143-155``);
    applied before SN, matching the reference order."""
    w = ctx.param(name, "W", (input_dim, output_dim), inits.linear_uniform(initialization, gain))
    if weightnorm:
        from rcgan_tpu.ops.conv import _weightnormed

        w = _weightnormed(ctx, name, w, axes=(0,))
    if spectral_normed:
        w = spectral_normed_weight(ctx, name, w)

    lead = x.shape[:-1]
    if x.ndim > 2:
        x = x.reshape(-1, input_dim)
    out = _matmul(x, w, ctx.compute_dtype)
    if len(lead) > 1:
        out = out.reshape(*lead, output_dim)
    if biases:
        b = ctx.param(name, "b", (output_dim,), inits.zeros)
        out = out + b.astype(out.dtype)
    return out


def embed_y(
    ctx: Ctx,
    labels: jax.Array,
    vocab_size: int = 10,
    embedding_dim: int = 300,
    name: str = "Embedding.Label",
    frozen_table=None,
):
    """Label embedding table, uniform(+-0.08) init
    (``cifar10/common/ops/embedding.py:12-51``).  ``labels`` are int ids.

    ``frozen_table``: pretrained (e.g. word2vec) embeddings used as a
    NON-trainable table — the reference's ``word2vec_file`` option; stored
    in state so no gradients flow."""
    if frozen_table is not None:
        table = ctx.stat(
            name, "embedding_map_frozen", frozen_table.shape,
            lambda key, shape, dtype: jnp.asarray(frozen_table, dtype),
        )
        return jnp.take(jax.lax.stop_gradient(table), labels, axis=0)
    table = ctx.param(name, "embedding_map", (vocab_size, embedding_dim), inits.uniform_range(0.08))
    return jnp.take(table, labels, axis=0)
