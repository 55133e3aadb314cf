"""Inception-score evaluation, device-resident.

The scoring math is the exp-KL-over-splits estimator of
``cifar10/common/inception/inception_score_.py:61-68``; the classifier is
pluggable.  The reference loads Google's frozen Inception-v3 GraphDef (not
redistributable here — zero-egress environment), so the default scorer is
the compact CIFAR ResNet from :mod:`rcgan_tpu.evals.classifier`; scores with
it are self-consistent across runs/modes but are NOT on the Inception-v3
scale (the 11.31 real-data anchor).  Drop in any ``logits_fn`` (e.g. a JAX
Inception-v3 port with real weights) to get paper-scale numbers.

Unlike the reference — which pauses training for minutes generating 50k
samples 100 at a time through feed_dict (``gan_resnet.py:838-845``) — sample
generation and classification here are one jitted batched loop on device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

import jax



def preds_to_score(preds: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """``exp(E KL(p(y|x) || p(y)))`` per split; returns (mean, std)
    (``inception_score_.py:61-68``).

    Probabilities are floored at 1e-20: a very confident classifier
    underflows f32 softmax to exact 0, and ``0 * log(0)`` NaNs the KL.
    The clamp changes the score by O(1e-19) — the limit of p·log p at
    p→0 is 0, which the floor reproduces."""
    preds = np.clip(np.asarray(preds, np.float64), 1e-20, 1.0)
    scores = []
    n = preds.shape[0]
    for i in range(splits):
        part = preds[i * n // splits : (i + 1) * n // splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(
    sample_fn: Callable[[jax.Array, int], jax.Array],
    logits_fn: Callable[[jax.Array], jax.Array],
    n: int = 50000,
    batch: int = 500,
    splits: int = 10,
    rng: jax.Array | None = None,
) -> Tuple[float, float]:
    """Generate ``n`` samples with ``sample_fn(key, batch)`` and score them.

    ``sample_fn`` returns images shaped for ``logits_fn``; generation and
    classification of ALL ``n // batch`` batches run as ONE ``lax.scan``ned
    device program with a single host fetch of the [n, classes]
    probabilities, instead of one dispatch and host sync per batch (the
    reference paused minutes per score, ``inception_score_.py:28``).
    Per-batch keys are unchanged
    (``fold_in(rng, i)``), so scores are identical to the per-batch path.
    """
    rng = jax.random.key(0) if rng is None else rng
    keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(np.arange(n // batch))

    @jax.jit
    def all_steps(keys):
        def body(_, key):
            imgs = sample_fn(key, batch)
            return None, jax.nn.softmax(logits_fn(imgs), axis=-1)

        _, out = jax.lax.scan(body, None, keys)
        return out.reshape(-1, out.shape[-1])

    return preds_to_score(np.asarray(all_steps(keys)), splits)


def real_data_score(
    images: np.ndarray,
    logits_fn: Callable[[jax.Array], jax.Array],
    batch: int = 500,
    splits: int = 10,
) -> Tuple[float, float]:
    """Score of REAL images under the same estimator — the sanity anchor the
    reference records as a comment (11.34 / 11.31±0.08 for the CIFAR-10
    train set under Inception-v3, ``inception_score_.py:82``).  Run this
    once per scorer to calibrate what "real data" scores."""
    import jax.numpy as jnp

    @jax.jit
    def step(x):
        return jax.nn.softmax(logits_fn(x), axis=-1)

    preds = []
    for i in range(0, len(images) - batch + 1, batch):
        preds.append(np.asarray(step(jnp.asarray(images[i : i + batch]))))
    return preds_to_score(np.concatenate(preds, axis=0), splits)
