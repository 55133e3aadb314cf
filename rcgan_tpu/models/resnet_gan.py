"""CIFAR-10 SNGAN: ResNet generator with conditional batch-norm and a
spectral-normed ResNet discriminator with projection head
(reference: ``cifar10/gan_resnet.py:199-483``).

Layer names mirror the reference variable scopes (``G.Block.1.Conv1`` etc.)
so parameter-count audits and optimizer partitions line up.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops import (
    batch_norm,
    cond_batchnorm,
    conv2d_lib,
    embed_y,
    layer_norm,
    linear_lib,
    lrelu,
    mean_pool,
    upsample_depth_to_space,
)


@dataclasses.dataclass(frozen=True)
class ResnetGANConfig:
    img_size: int = 32
    img_dim: int = 3
    z_dim: int = 128
    dim_g: int = 128
    dim_d: int = 128
    vocab_size: int = 10
    embedding_dim: int = 300
    normalization_g: bool = True
    normalization_d: bool = False
    conditional: bool = True
    acgan: bool = False
    algorithm: str = "rcgan"  # biased | unbiased | rcgan | rcgan-u
    perm_type: str = "linear"  # linear | 2layer
    nonlinearity: str = "relu"

    @property
    def output_dim(self) -> int:
        return self.img_size * self.img_size * self.img_dim


def nonlinearity(x, kind: str = "relu", leakiness: float = 0.2):
    if kind == "relu":
        return jax.nn.relu(x)
    if kind == "lrelu":
        return lrelu(x, leakiness)
    raise ValueError(kind)


def normalize(ctx: Ctx, cfg: ResnetGANConfig, name: str, x, labels=None):
    """Routes to cond-BN / BN / layer-norm / identity by scope name and
    config, reproducing ``gan_resnet.py:207-228``."""
    if not cfg.conditional:
        labels = None
    if cfg.conditional and cfg.acgan and ("D." in name):
        labels = None
    if ("D." in name) and cfg.normalization_d:
        return layer_norm(ctx, x, name)
    if ("G." in name) and cfg.normalization_g:
        if labels is not None:
            return cond_batchnorm(ctx, x, labels, cfg.vocab_size, name)
        return batch_norm(ctx, x, name, zero_debias=True)
    return x


def conv_mean_pool(ctx, x, input_dim, output_dim, filter_size, name, spectral_normed=False,
                   he_init=True, biases=True):
    out = conv2d_lib(ctx, x, input_dim, output_dim, filter_size, 1, name,
                     spectral_normed=spectral_normed, he_init=he_init, biases=biases)
    return mean_pool(out)


def mean_pool_conv(ctx, x, input_dim, output_dim, filter_size, name, spectral_normed=False,
                   he_init=True, biases=True):
    out = mean_pool(x)
    return conv2d_lib(ctx, out, input_dim, output_dim, filter_size, 1, name,
                      spectral_normed=spectral_normed, he_init=he_init, biases=biases)


def upsample_conv(ctx, x, input_dim, output_dim, filter_size, name, spectral_normed=False,
                  he_init=True, biases=True):
    out = upsample_depth_to_space(x)
    return conv2d_lib(ctx, out, input_dim, output_dim, filter_size, 1, name,
                      spectral_normed=spectral_normed, he_init=he_init, biases=biases)


def residual_block(
    ctx: Ctx,
    cfg: ResnetGANConfig,
    x: jax.Array,
    input_dim: int,
    output_dim: int,
    filter_size: int,
    name: str,
    resample: Optional[str] = None,
    labels: Optional[jax.Array] = None,
    spectral_normed: bool = False,
    biases: bool = True,
):
    """(norm → relu → conv) x2 + shortcut, with up/down/no resampling
    (``gan_resnet.py:275-328``)."""
    if resample == "down":
        conv_1 = lambda h, nm: conv2d_lib(ctx, h, input_dim, input_dim, filter_size, 1, nm,
                                          spectral_normed=spectral_normed, biases=biases)
        conv_2 = lambda h, nm: conv_mean_pool(ctx, h, input_dim, output_dim, filter_size, nm,
                                              spectral_normed=spectral_normed, biases=biases)
        shortcut_fn = lambda h, nm: conv_mean_pool(ctx, h, input_dim, output_dim, 1, nm,
                                                   spectral_normed=spectral_normed, he_init=False,
                                                   biases=biases)
    elif resample == "up":
        conv_1 = lambda h, nm: upsample_conv(ctx, h, input_dim, output_dim, filter_size, nm,
                                             spectral_normed=spectral_normed, biases=biases)
        conv_2 = lambda h, nm: conv2d_lib(ctx, h, output_dim, output_dim, filter_size, 1, nm,
                                          spectral_normed=spectral_normed, biases=biases)
        shortcut_fn = lambda h, nm: upsample_conv(ctx, h, input_dim, output_dim, 1, nm,
                                                  spectral_normed=spectral_normed, he_init=False,
                                                  biases=biases)
    elif resample is None:
        conv_1 = lambda h, nm: conv2d_lib(ctx, h, input_dim, output_dim, filter_size, 1, nm,
                                          spectral_normed=spectral_normed, biases=biases)
        conv_2 = lambda h, nm: conv2d_lib(ctx, h, output_dim, output_dim, filter_size, 1, nm,
                                          spectral_normed=spectral_normed, biases=biases)
        shortcut_fn = lambda h, nm: conv2d_lib(ctx, h, input_dim, output_dim, 1, 1, nm,
                                               spectral_normed=spectral_normed, he_init=False,
                                               biases=biases)
    else:
        raise ValueError(f"invalid resample {resample!r}")

    if output_dim == input_dim and resample is None:
        shortcut = x
    else:
        shortcut = shortcut_fn(x, name + ".Shortcut")

    out = normalize(ctx, cfg, name + ".N1", x, labels)
    out = nonlinearity(out, cfg.nonlinearity)
    out = conv_1(out, name + ".Conv1")
    out = normalize(ctx, cfg, name + ".N2", out, labels)
    out = nonlinearity(out, cfg.nonlinearity)
    out = conv_2(out, name + ".Conv2")
    return shortcut + out


def optimized_resblock_disc1(ctx: Ctx, cfg: ResnetGANConfig, x: jax.Array, biases: bool = True):
    """First D block: conv → relu → conv-mean-pool, mean-pool-conv shortcut
    (``gan_resnet.py:331-353``), all spectral-normed."""
    shortcut = mean_pool_conv(ctx, x, cfg.img_dim, cfg.dim_d, 1, "D.Block.1.Shortcut",
                              spectral_normed=True, he_init=False, biases=biases)
    out = conv2d_lib(ctx, x, cfg.img_dim, cfg.dim_d, 3, 1, "D.Block.1.Conv1",
                     spectral_normed=True, biases=biases)
    out = nonlinearity(out, cfg.nonlinearity)
    out = conv_mean_pool(ctx, out, cfg.dim_d, cfg.dim_d, 3, "D.Block.1.Conv2",
                         spectral_normed=True, biases=biases)
    return shortcut + out


def generator(ctx: Ctx, cfg: ResnetGANConfig, z: jax.Array, labels: jax.Array):
    """z [B, z_dim], labels int [B] → flat image [B, output_dim] in [-1, 1]."""
    g = cfg.dim_g
    out = linear_lib(ctx, z, cfg.z_dim, 4 * 4 * g * 8, "G.Input")
    out = out.reshape(-1, 4, 4, g * 8)
    out = residual_block(ctx, cfg, out, g * 8, g * 2, 3, "G.Block.1", resample="up", labels=labels)
    out = residual_block(ctx, cfg, out, g * 2, g * 2, 3, "G.Block.2", resample="up", labels=labels)
    out = residual_block(ctx, cfg, out, g * 2, g * 2, 3, "G.Block.3", resample="up", labels=labels)
    out = normalize(ctx, cfg, "G.OutputNorm", out, labels)
    out = nonlinearity(out, cfg.nonlinearity)
    out = conv2d_lib(ctx, out, g * 2, cfg.img_dim, 3, 1, "G.Output", he_init=False)
    out = jnp.tanh(out)
    return out.reshape(-1, cfg.output_dim)


def discriminator(ctx: Ctx, cfg: ResnetGANConfig, inputs: jax.Array, labels: jax.Array):
    """Flat image [B, output_dim] → (features [B, dim_d], wgan logit [B]).

    For ``unbiased``/``rcgan-u`` the conditional path inside D is disabled
    (``gan_resnet.py:376-379``) — moot when normalization_d is off, but kept
    for parity with configs that enable D normalization.
    """
    labels_disc = None if cfg.algorithm in ("unbiased", "rcgan-u") else labels
    d = cfg.dim_d
    out = inputs.reshape(-1, cfg.img_size, cfg.img_size, cfg.img_dim)
    out = optimized_resblock_disc1(ctx, cfg, out)
    out = residual_block(ctx, cfg, out, d, d, 3, "D.Block.2", resample="down",
                         labels=labels_disc, spectral_normed=True)
    for i in (3, 4, 5, 6):
        out = residual_block(ctx, cfg, out, d, d, 3, f"D.Block.{i}", resample=None,
                             labels=labels_disc, spectral_normed=True)
    out = nonlinearity(out, cfg.nonlinearity)
    out = jnp.mean(out, axis=(1, 2))  # [B, dim_d]
    out_wgan = linear_lib(ctx, out, d, 1, "D.Output", spectral_normed=True, biases=True)
    return out, out_wgan.reshape(-1)


def discriminator_projection(ctx: Ctx, cfg: ResnetGANConfig, labels: jax.Array):
    """Label → embedding [vocab, emb_dim] → SN linear → [B, dim_d]
    (``gan_resnet.py:414-421``)."""
    emb = embed_y(ctx, labels, cfg.vocab_size, cfg.embedding_dim, name="D.Embedding.Label")
    return linear_lib(ctx, emb, cfg.embedding_dim, cfg.dim_d, "D.Embedding_y",
                      spectral_normed=True, biases=True)


def projection_logits(features: jax.Array, wgan: jax.Array, embedding_y: jax.Array) -> jax.Array:
    """``output_wgan + Σ output·embedding_y`` — the projection-discriminator
    logit formed at call sites (``gan_resnet.py:588,650``)."""
    return wgan + jnp.sum(features * embedding_y, axis=1)


def all_label_logits(ctx: Ctx, cfg: ResnetGANConfig, features: jax.Array, wgan: jax.Array):
    """Logits against *every* label's embedding: [B, vocab]
    (``gan_resnet.py:654-660``) — the rcgan-u expected-loss path."""
    all_labels = jnp.arange(cfg.vocab_size)
    emb = discriminator_projection(ctx, cfg, all_labels)  # [vocab, dim_d]
    with jax.named_scope("all_label_logits"):
        return wgan[:, None] + features @ emb.T


def perm_classifier(ctx: Ctx, cfg: ResnetGANConfig, x: jax.Array):
    """Permutation-regularizer classifier (``gan_resnet.py:458-483``):
    SN linear (or 2-layer) on the flat image, named ``D.*`` so it trains
    with the discriminator optimizer."""
    x = x.reshape(-1, cfg.output_dim)
    if cfg.perm_type == "linear":
        return linear_lib(ctx, x, cfg.output_dim, cfg.vocab_size, "D.d_perm_classifier_h1",
                          spectral_normed=True, biases=True)
    if cfg.perm_type == "2layer":
        h = linear_lib(ctx, x, cfg.output_dim, 128, "D.d_perm_classifier_h1",
                       spectral_normed=True, biases=True)
        return linear_lib(ctx, h, 128, cfg.vocab_size, "D.d_perm_classifier_h2",
                          spectral_normed=True, biases=True)
    raise ValueError(f"Unknown perm_type {cfg.perm_type}")
