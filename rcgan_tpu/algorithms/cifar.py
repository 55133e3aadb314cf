"""CIFAR-10 loss graphs for the four algorithms
(reference: disc-cost loop ``cifar10/gan_resnet.py:557-699``, gen-cost loop
``708-786``, confusion optimizer ``810-817``).

Written per-shard: the train step runs these inside ``shard_map`` over the
data mesh axis and psums gradients — the SPMD replacement for the
reference's per-GPU tower loop + ``/len(DEVICES)`` averaging.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu.core import initializers as inits
from rcgan_tpu.core.module import Ctx, sn_updates
from rcgan_tpu.algorithms.losses import d_fake_loss, d_real_loss, g_loss, sigmoid_ce
from rcgan_tpu.models.resnet_gan import (
    ResnetGANConfig,
    all_label_logits,
    discriminator,
    discriminator_projection,
    generator,
    perm_classifier,
    projection_logits,
)


@dataclasses.dataclass(frozen=True)
class CifarAlgoConfig:
    algorithm: str = "rcgan"  # biased | unbiased | rcgan | rcgan-u
    loss_type: str = "HINGE"  # HINGE | Goodfellow | WGAN
    soft_plus: bool = False
    perm_classifier: bool = False
    perm_multiplier: float = 1.0
    confuse_init: bool = False
    confuse_init_diag: float = 0.2
    vocab_size: int = 10


def confusion_init_values(acfg) -> np.ndarray:
    """Diagonal-dominant logits init (``gan_resnet.py:505-520``).

    Takes any config exposing ``vocab_size``/``y_dim`` and
    ``confuse_init_diag`` — shared by the CIFAR stack and the MNIST
    ``--confuse_init`` port (round-4 RCGAN-U stabilization study).
    """
    v = getattr(acfg, "vocab_size", None) or acfg.y_dim
    d = acfg.confuse_init_diag
    if d > 0.99 and v == 10:
        aa = 7.0
    else:
        aa = np.log(v * d / (1.0 - d))
    aa = min(7.0, aa)
    out = (0.0 - aa / v) * np.ones((v, v), np.float32)
    np.fill_diagonal(out, aa - aa / v)
    return out


def confusion_matrix(ctx: Ctx, acfg: CifarAlgoConfig, c_actual: Optional[jax.Array]):
    if acfg.algorithm == "rcgan-u":
        if acfg.confuse_init:
            vals = jnp.asarray(confusion_init_values(acfg))
            init_fn = lambda key, shape, dtype: vals.astype(dtype)
        else:
            init_fn = inits.glorot_uniform()
        logits = ctx.param(
            "confusion_logits", "logits", (acfg.vocab_size, acfg.vocab_size), init_fn
        )
        return jax.nn.softmax(logits, axis=-1)
    assert c_actual is not None
    return c_actual


def disc_loss(
    ctx: Ctx,
    cfg: ResnetGANConfig,
    acfg: CifarAlgoConfig,
    batch: dict,
    z: jax.Array,
    c_actual: Optional[jax.Array] = None,
):
    """Per-shard discriminator cost (one tower of ``gan_resnet.py:557-699``).

    ``batch``: real_data [b, output_dim] float (already dequantized HWC-flat),
    int labels / labels_random / labels_biased [b], labels_inv_weights [b, V].
    """
    alg = acfg.algorithm
    lt, sp = acfg.loss_type, acfg.soft_plus
    b = batch["real_data"].shape[0]
    cmat = confusion_matrix(ctx, acfg, c_actual)

    fake = generator(ctx, cfg, z, batch["labels_random"])

    if alg == "rcgan-u":
        # real pass alone, then fake pass against all labels (649-685)
        feat_r, wgan_r = discriminator(ctx, cfg, batch["real_data"], batch["labels"])
        emb_r = discriminator_projection(ctx, cfg, batch["labels"])
        disc_real = projection_logits(feat_r, wgan_r, emb_r)
        real_l = jnp.mean(d_real_loss(disc_real, lt, sp))

        feat_f, wgan_f = discriminator(ctx, cfg, fake, batch["labels_random"])
        logits_all = all_label_logits(ctx, cfg, feat_f, wgan_f)  # [b, V]
        fake_y = d_fake_loss(logits_all, lt, sp)
        w = jnp.take(cmat, batch["labels_random"], axis=0)  # C[y_gen]
        cost = jnp.mean(jnp.sum(fake_y * w, axis=1)) + real_l
        disc_fake = jnp.sum(logits_all * w, axis=1)
    else:
        data = jnp.concatenate([batch["real_data"], fake], axis=0)
        if alg in ("biased", "unbiased"):
            rf_labels = jnp.concatenate([batch["labels"], batch["labels_random"]], axis=0)
        elif alg == "rcgan":
            rf_labels = jnp.concatenate([batch["labels"], batch["labels_biased"]], axis=0)
        else:
            raise ValueError(alg)
        feat, wgan = discriminator(ctx, cfg, data, rf_labels)

        if alg in ("biased", "rcgan"):
            emb = discriminator_projection(ctx, cfg, rf_labels)
            disc_all = projection_logits(feat, wgan, emb)
            disc_real, disc_fake = disc_all[:b], disc_all[b:]
            cost = jnp.mean(d_real_loss(disc_real, lt, sp)) + jnp.mean(
                d_fake_loss(disc_fake, lt, sp)
            )
        else:  # unbiased: real term at ALL labels, C^-1-weighted (613-648)
            logits_all_r = all_label_logits(ctx, cfg, feat[:b], wgan[:b])  # [b, V]
            real_elem = d_real_loss(logits_all_r, lt, sp)
            real_l = jnp.mean(jnp.sum(real_elem * batch["labels_inv_weights"], axis=1))
            emb_f = discriminator_projection(ctx, cfg, batch["labels_random"])
            disc_fake = projection_logits(feat[b:], wgan[b:], emb_f)
            fake_l = jnp.mean(d_fake_loss(disc_fake, lt, sp))
            cost = real_l + fake_l
            disc_real = jnp.sum(logits_all_r * batch["labels_inv_weights"], axis=1)

    if acfg.perm_classifier:
        logits = perm_classifier(ctx, cfg, batch["real_data"])
        perm_real = jnp.mean(
            sigmoid_ce(logits, jax.nn.one_hot(batch["labels"], acfg.vocab_size))
        )
        cost = cost + 1.0 * perm_real
    else:
        perm_real = jnp.zeros(())

    return {
        "disc_cost": cost,
        "disc_real": disc_real,
        "disc_fake": disc_fake,
        "perm_real": perm_real,
        "confusion": cmat,
    }


def gen_loss(
    ctx: Ctx,
    cfg: ResnetGANConfig,
    acfg: CifarAlgoConfig,
    labels_random_g: jax.Array,
    labels_biased_g: jax.Array,
    z: jax.Array,
    c_actual: Optional[jax.Array] = None,
):
    """Per-shard generator cost (one tower of ``gan_resnet.py:715-786``).
    D's conv ``u`` vectors are frozen here (NO_OPS) but the projection
    embedding's still updates — reference parity."""
    alg = acfg.algorithm
    lt, sp = acfg.loss_type, acfg.soft_plus
    cmat = confusion_matrix(ctx, acfg, c_actual)

    fake = generator(ctx, cfg, z, labels_random_g)

    d_labels = labels_random_g if alg in ("biased", "unbiased") else labels_biased_g
    with sn_updates(ctx, False):
        feat, wgan = discriminator(ctx, cfg, fake, d_labels)

    if alg == "rcgan-u":
        logits_all = all_label_logits(ctx, cfg, feat, wgan)  # [b, V]
        fake_y = g_loss(logits_all, lt, sp)
        w = jnp.take(cmat, labels_random_g, axis=0)
        cost = jnp.mean(jnp.sum(fake_y * w, axis=1))
    else:
        emb = discriminator_projection(ctx, cfg, d_labels)
        disc_fake = projection_logits(feat, wgan, emb)
        cost = jnp.mean(g_loss(disc_fake, lt, sp))

    if acfg.perm_classifier:
        logits = perm_classifier(ctx, cfg, fake)
        perm_fake = jnp.mean(
            sigmoid_ce(logits, jax.nn.one_hot(labels_random_g, acfg.vocab_size))
        )
        cost = cost + acfg.perm_multiplier * perm_fake
    else:
        perm_fake = jnp.zeros(())

    return {"gen_cost": cost, "perm_fake": perm_fake, "confusion": cmat, "G": fake}


def partition_predicates():
    """Optimizer partition (``gan_resnet.py:788-800``): scope prefixes."""
    return {
        "confusion": lambda n: n == "confusion_logits",
        "gen": lambda n: n.startswith("G."),
        "disc": lambda n: n.startswith("D."),
    }


def lr_decay(iteration, decay: bool = True):
    """Linear LR decay with 0.5 floor after iter 50k
    (``gan_resnet.py:700-705``)."""
    if not decay:
        return jnp.ones(())
    it = jnp.asarray(iteration, jnp.float32)
    return jnp.where(it < 50000.0, jnp.maximum(0.0, 1.0 - it / 100000.0), 0.5)
