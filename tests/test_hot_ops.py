"""The five hot ops of the CIFAR cycle on their plain jax.numpy/lax path,
against float64 NumPy oracles at the flagship widths: the 3x3 conv,
conditional batch-norm (with gradients), spectral norm (with its gradient
through the power iteration and its precision pin), the all-label
projection logits, and the dequantize step (range, channel order, sharding
invariance)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops.conv import conv2d_lib
from rcgan_tpu.ops.norm import cond_batchnorm
from rcgan_tpu.ops.sn import spectral_normed_weight


def np_conv3x3(x, w):
    x = np.pad(np.asarray(x, np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(x, (3, 3), axis=(1, 2))
    return np.einsum("bhwcij,ijco->bhwo", win, np.asarray(w, np.float64), optimize=True)


@pytest.mark.parametrize("size", [32, 16, 8])
def test_conv3x3_128_channels_matches_numpy(size):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, size, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) / np.sqrt(9 * 128)).astype(np.float32)
    ctx = Ctx(params={"c": {"Filters": jnp.asarray(w)}})
    out = jax.jit(lambda x: conv2d_lib(ctx, x, 128, 128, 3, 1, "c", biases=False))(x)
    np.testing.assert_allclose(np.asarray(out), np_conv3x3(x, w), rtol=1e-4, atol=1e-4)


def _np_cond_bn_fwd_bwd(x, labels, scale_m, offset_m, dy, eps=1e-5):
    """Forward and analytic backward of conditional BN in float64."""
    x, dy = np.asarray(x, np.float64), np.asarray(dy, np.float64)
    axes = (0, 1, 2)
    mean = x.mean(axis=axes, keepdims=True)
    inv = 1.0 / np.sqrt(((x - mean) ** 2).mean(axis=axes, keepdims=True) + eps)
    xhat = (x - mean) * inv
    scale = np.asarray(scale_m, np.float64)[labels][:, None, None, :]
    offset = np.asarray(offset_m, np.float64)[labels][:, None, None, :]
    y = xhat * scale + offset
    g = dy * scale
    dx = inv * (g - g.mean(axis=axes, keepdims=True)
                - xhat * (g * xhat).mean(axis=axes, keepdims=True))
    d_scale = np.zeros_like(np.asarray(scale_m, np.float64))
    d_offset = np.zeros_like(d_scale)
    np.add.at(d_scale, labels, (dy * xhat).sum(axis=(1, 2)))
    np.add.at(d_offset, labels, dy.sum(axis=(1, 2)))
    return y, dx, d_scale, d_offset


@pytest.mark.parametrize("b,s", [(128, 32), (128, 16), (64, 16)])
def test_cond_batchnorm_flagship_shapes_and_grads_match_numpy(b, s):
    rs = np.random.RandomState(b + s)
    x = (2.0 * rs.randn(b, s, s, 128) + 0.5).astype(np.float32)
    labels = rs.randint(0, 10, b)
    scale_m = (1.0 + 0.1 * rs.randn(10, 128)).astype(np.float32)
    offset_m = (0.1 * rs.randn(10, 128)).astype(np.float32)
    dy = rs.randn(b, s, s, 128).astype(np.float32)

    def f(x, sm, om):
        return cond_batchnorm(Ctx(params={"bn": {"scale": sm, "offset": om}}), x,
                              jnp.asarray(labels), 10, "bn")

    y, vjp = jax.vjp(jax.jit(f), x, scale_m, offset_m)
    dx, d_scale, d_offset = vjp(jnp.asarray(dy))
    ref = _np_cond_bn_fwd_bwd(x, labels, scale_m, offset_m, dy)
    for got, want in zip((y, dx, d_scale, d_offset), ref):
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=0, atol=2e-5)


def np_sn(w, u, eps=1e-12):
    w = np.asarray(w, np.float64).reshape(-1, np.shape(w)[-1])
    v = np.asarray(u, np.float64) @ w.T
    v = v / (np.sqrt(np.sum(v**2)) + eps)
    u2 = v @ w
    u2 = u2 / (np.sqrt(np.sum(u2**2)) + eps)
    sigma = (v @ w @ u2.T)[0, 0]
    return w / sigma, sigma


def test_sn_one_step_matches_numpy_on_flagship_weights():
    rs = np.random.RandomState(5)
    w = (0.05 * rs.randn(3, 3, 128, 128)).astype(np.float32)  # [1152, 128]
    u = rs.randn(1, 128).astype(np.float32)
    ctx = Ctx(state={"sn": {"u": jnp.asarray(u)}})
    wb, sigma = spectral_normed_weight(ctx, "sn", jnp.asarray(w), with_sigma=True)
    wb_ref, sigma_ref = np_sn(w, u)
    np.testing.assert_allclose(np.asarray(wb).reshape(1152, 128), wb_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(sigma), sigma_ref, rtol=1e-6)
    # one step from a cold u is a lower bound on the top singular value
    assert float(sigma) <= np.linalg.svd(w.reshape(1152, 128), compute_uv=False)[0] * (1 + 1e-6)


def test_sn_precision_is_pinned_and_matches_svd():
    """sigma scales every D weight: its matvecs ask for HIGHEST precision,
    whatever the default matmul precision, and iterate to the SVD value."""
    rs = np.random.RandomState(7)
    w = jnp.asarray(rs.randn(1152, 128).astype(np.float32))
    ctx = Ctx(state={"sn": {"u": jnp.asarray(rs.randn(1, 128).astype(np.float32))}})

    def sigma_of(w):
        return spectral_normed_weight(ctx, "sn", w, num_iters=200, with_sigma=True)[1]

    with jax.default_matmul_precision("tensorfloat32"):
        jaxpr = jax.make_jaxpr(sigma_of)(w)
        sigma = float(jax.jit(sigma_of)(w))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    for e in jax.jit(sigma_of).trace(w).jaxpr.eqns:
        for sub in jax.core.jaxprs_in_params(e.params):
            dots += [s for s in sub.eqns if s.primitive.name == "dot_general"]
    assert dots and all(
        e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2 for e in dots), dots
    svd = np.linalg.svd(np.asarray(w, np.float64), compute_uv=False)[0]
    np.testing.assert_allclose(sigma, svd, rtol=1e-4)


def test_sn_gradient_flows_through_power_iteration():
    """Directional derivatives of a loss on W/sigma against float64 central
    differences of the same one-step power iteration (no stop-gradient)."""
    rs = np.random.RandomState(6)
    w = (0.05 * rs.randn(1152, 128)).astype(np.float32)
    u = rs.randn(1, 128).astype(np.float32)
    g_out = rs.randn(1152, 128)

    def loss(wm):
        wb = spectral_normed_weight(Ctx(state={"sn": {"u": jnp.asarray(u)}}), "sn", wm)
        return jnp.sum(jnp.tanh(wb) * jnp.asarray(g_out, jnp.float32))

    def loss_np(wm):
        return float(np.sum(np.tanh(np_sn(wm, u)[0]) * g_out))

    grad = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(w)), np.float64)
    for i in range(3):
        d = np.random.RandomState(10 + i).randn(*w.shape)
        h = 1e-6
        fd = (loss_np(w.astype(np.float64) + h * d) - loss_np(w.astype(np.float64) - h * d)) / (2 * h)
        np.testing.assert_allclose(np.sum(grad * d), fd, rtol=1e-4)


def test_all_label_logits_match_formula_through_model_code():
    from rcgan_tpu.models import resnet_gan

    cfg = resnet_gan.ResnetGANConfig()
    rs = np.random.RandomState(3)
    feat = rs.randn(64, 128).astype(np.float32)
    wgan = rs.randn(64).astype(np.float32)
    init = Ctx(rng=jax.random.key(0), init=True)
    resnet_gan.all_label_logits(init, cfg, jnp.asarray(feat), jnp.asarray(wgan))
    ctx = Ctx(params=init.params, state=init.state, update_sn=False)
    out = resnet_gan.all_label_logits(ctx, cfg, jnp.asarray(feat), jnp.asarray(wgan))
    w_bar, _ = np_sn(init.params["D.Embedding_y"]["W"], init.state["D.Embedding_y"]["u"])
    emb = (np.asarray(init.params["D.Embedding.Label"]["embedding_map"], np.float64) @ w_bar
           + np.asarray(init.params["D.Embedding_y"]["b"], np.float64))
    ref = wgan[:, None] + feat.astype(np.float64) @ emb.T
    assert out.shape == (64, 10)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


def test_all_label_logits_bf16_cotangents_keep_primal_dtypes():
    """Regression: the unbiased all-label real pass slices the logits under
    bf16 compute; every cotangent must come back in its primal's dtype (an
    f32 cotangent against a bf16 primal trips JAX's aval check)."""
    from rcgan_tpu.models import resnet_gan

    cfg = resnet_gan.ResnetGANConfig(dim_d=16, embedding_dim=16)
    rs = np.random.RandomState(0)
    feat = jnp.asarray(rs.randn(8, 16), jnp.bfloat16)
    wgan = jnp.asarray(rs.randn(8), jnp.bfloat16)
    init = Ctx(rng=jax.random.key(0), init=True, compute_dtype=jnp.bfloat16)
    resnet_gan.all_label_logits(init, cfg, feat, wgan)

    def loss(params, f, w):
        ctx = Ctx(params=params, state=init.state, update_sn=False, compute_dtype=jnp.bfloat16)
        logits = resnet_gan.all_label_logits(ctx, cfg, f, w)
        return jnp.sum(logits[:4].astype(jnp.float32))  # slice like unbiased

    dp, df, dw = jax.grad(loss, argnums=(0, 1, 2))(init.params, feat, wgan)
    assert df.dtype == feat.dtype and dw.dtype == wgan.dtype
    for leaf, g in zip(jax.tree_util.tree_leaves(init.params), jax.tree_util.tree_leaves(dp)):
        assert g.dtype == leaf.dtype


def _dequantize(images, rng, axis=None):
    from rcgan_tpu.core.rng import example_keys
    from rcgan_tpu.data.cifar10 import dequantize_chw_to_hwc_keys

    return dequantize_chw_to_hwc_keys(images, example_keys(rng, images.shape[0], axis))


def test_dequantize_range_and_channel_order():
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (64, 3072)).astype(np.int32)
    out = np.asarray(jax.jit(_dequantize)(images, jax.random.key(3)), np.float64)
    base = (2.0 * (images / 256.0 - 0.5)).reshape(64, 3, 32, 32).transpose(0, 2, 3, 1)
    noise = out - base.reshape(64, 3072)
    assert noise.min() >= 0.0 and noise.max() < 1.0 / 128 + 1e-7
    assert abs(noise.mean() - 0.5 / 128) < 3e-5  # 6 standard errors of 196608 uniforms
    assert out.min() >= -1.0 and out.max() < 1.0 + 1.0 / 128


def test_dequantize_noise_invariant_under_sharding():
    """Noise is keyed by global example index: 4-way sharded == unsharded."""
    from jax.sharding import PartitionSpec as P

    from rcgan_tpu.parallel.mesh import make_mesh

    images = np.random.RandomState(8).randint(0, 256, (16, 3072)).astype(np.int32)
    rng = jax.random.key(11)
    whole = jax.jit(_dequantize)(images, rng)
    sharded = jax.jit(jax.shard_map(
        lambda x, r: _dequantize(x, r, axis="data"), mesh=make_mesh(4),
        in_specs=(P("data"), P()), out_specs=P("data")))(images, rng)
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(whole))
