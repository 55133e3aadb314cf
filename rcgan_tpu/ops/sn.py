"""Spectral normalization via power iteration with explicit ``u`` state.

Reference behavior (``mnist/sn.py:13-75`` == ``cifar10/common/ops/sn.py``):
the weight is flattened to ``[-1, cout]``, a persistent non-trainable
``u [1, cout]`` does one power-iteration step per call, ``sigma = v W u^T``,
and the layer uses ``W / sigma``.  TF hides the ``u`` update in control
dependencies / collections; here it is explicit state on the :class:`Ctx`,
gated by ``ctx.update_sn`` (the ``NO_OPS`` convention used during CIFAR
generator steps, ``cifar10/gan_resnet.py:723,729``).

``sigma`` is computed in float32 regardless of compute dtype, and its
matrix-vector products ask for ``HIGHEST`` precision: ``sigma`` scales every
discriminator weight, and a TF32 product would move it by ~1e-3.  The
products are two matvecs per call, far too small for the precision to cost
measurable time.  Gradients flow through the power iteration (reference
semantics; no stop-gradient on ``u``/``v``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rcgan_tpu.core import initializers as inits
from rcgan_tpu.core.module import Ctx


def _l2normalize(v: jax.Array, eps: float = 1e-12) -> jax.Array:
    return v / (jnp.sum(v**2) ** 0.5 + eps)


def _matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@jax.named_scope("sn")
def spectral_normed_weight(
    ctx: Ctx,
    layer: str,
    w: jax.Array,
    num_iters: int = 1,
    with_sigma: bool = False,
):
    """Return ``w / sigma_max(w)`` estimated by power iteration.

    ``layer`` keys the persistent ``u`` vector in ``ctx`` state.  When
    ``ctx.update_sn`` is False the iteration still runs (sigma uses the
    refreshed ``u``) but the stored ``u`` is not advanced — matching the
    reference, where ``NO_OPS`` skips only the assign, not the while_loop.
    """
    w32 = w.astype(jnp.float32)
    w_shape = w32.shape
    w_mat = w32.reshape(-1, w_shape[-1])
    cout = w_mat.shape[1]

    u = ctx.stat(layer, "u", (1, cout), inits.truncated_normal(1.0))
    u = u.astype(jnp.float32)

    def body(_, carry):
        u_i, _v = carry
        v_n = _l2normalize(_matmul(u_i, w_mat.T))
        u_n = _l2normalize(_matmul(v_n, w_mat))
        return u_n, v_n

    if num_iters == 1:  # unrolled fast path
        u_f, v_f = body(0, (u, None))
    else:
        u_f, v_f = jax.lax.fori_loop(
            0, num_iters, body, (u, jnp.zeros((1, w_mat.shape[0]), jnp.float32))
        )

    sigma = _matmul(_matmul(v_f, w_mat), u_f.T)[0, 0]
    w_bar = (w_mat / sigma).reshape(w_shape)

    if ctx.update_sn:
        ctx.put_stat(layer, "u", jax.lax.stop_gradient(u_f))

    w_bar = w_bar.astype(w.dtype)
    if with_sigma:
        return w_bar, sigma
    return w_bar


def exact_sigma(w: jax.Array) -> jax.Array:
    """SVD-based largest singular value of the flattened weight (test oracle)."""
    w_mat = w.reshape(-1, w.shape[-1]).astype(jnp.float32)
    return jnp.linalg.svd(w_mat, compute_uv=False)[0]
