"""Inception-v3 classifier in JAX for paper-scale inception scores.

The reference scores CIFAR samples with Google's frozen Inception-v3
GraphDef via tfgan (``cifar10/common/inception/inception_score_.py:26-48``)
and records the real-CIFAR-10 anchor 11.31 ± 0.08 (``:82``).  This module
is a from-scratch JAX implementation of the Inception-v3 inference graph
(torchvision layer layout) so the framework owns the scorer end-to-end:

- **Weights** are loaded from an ``.npz`` or pickle of numpy arrays using
  torchvision ``state_dict`` naming (``Conv2d_1a_3x3.conv.weight``,
  ``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``, ...).  Convert
  once on any machine with torchvision:
  ``np.savez(path, **{k: v.numpy() for k, v in
  torchvision.models.inception_v3(weights='DEFAULT').state_dict().items()})``
  and drop the file at ``<data_dir>/inception_v3.npz``.
- **Without weights** the apps keep using the compact CIFAR stand-in
  scorer (self-consistent, not on the 11.31 scale); with weights, scores
  land on the paper scale — calibrate once via
  ``evals.inception.real_data_score`` (expect ~11.3 on CIFAR-10 train;
  TF-slim vs torchvision weight ports differ by a few percent).

Everything is pure-functional inference: conv + frozen batch-norm + relu,
jitted end to end over one [B, 299, 299, 3] stream.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

# ImageNet eval preprocessing (torchvision): input in [0,1] normalized per
# channel.  Our pipelines hand images in [-1, 1].
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
_BN_EPS = 1e-3


# --------------------------------------------------------------------------
# primitive blocks (NHWC; weights stored OIHW as in the torch state_dict)
# --------------------------------------------------------------------------


def _conv_bn(params: Dict[str, jax.Array], name: str, x: jax.Array, stride=1, padding=0):
    """BasicConv2d: conv (no bias) + frozen BN(eps=1e-3) + relu."""
    w = params[f"{name}.conv.weight"]  # [O, I, KH, KW]
    if isinstance(padding, int):
        padding = (padding, padding)
    pads = ((padding[0], padding[0]), (padding[1], padding[1]))
    out = jax.lax.conv_general_dilated(
        x,
        w,
        window_strides=(stride, stride),
        padding=pads,
        dimension_numbers=("NHWC", "OIHW", "NHWC"),
    )
    gamma = params[f"{name}.bn.weight"]
    beta = params[f"{name}.bn.bias"]
    mean = params[f"{name}.bn.running_mean"]
    var = params[f"{name}.bn.running_var"]
    inv = gamma * jax.lax.rsqrt(var + _BN_EPS)
    return jax.nn.relu(out * inv + (beta - mean * inv))


def _max_pool(x, window=3, stride=2):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, window, window, 1), (1, stride, stride, 1), "VALID"
    )


def _avg_pool_3x3_same(x):
    """3x3 stride-1 avg pool with pad 1, count_include_pad=True (torch
    default): sum over the padded window / 9."""
    s = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 3, 3, 1), (1, 1, 1, 1), [(0, 0), (1, 1), (1, 1), (0, 0)]
    )
    return s / 9.0


# --------------------------------------------------------------------------
# inception blocks (torchvision InceptionA..E)
# --------------------------------------------------------------------------


def _inception_a(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b5 = _conv_bn(p, f"{n}.branch5x5_1", x)
    b5 = _conv_bn(p, f"{n}.branch5x5_2", b5, padding=2)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_2", b3, padding=1)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_3", b3, padding=1)
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return jnp.concatenate([b1, b5, b3, bp], axis=-1)


def _inception_b(p, n, x):
    b3 = _conv_bn(p, f"{n}.branch3x3", x, stride=2)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_3", bd, stride=2)
    return jnp.concatenate([b3, bd, _max_pool(x)], axis=-1)


def _inception_c(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7_1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{n}.branch7x7_3", b7, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return jnp.concatenate([b1, b7, bd, bp], axis=-1)


def _inception_d(p, n, x):
    b3 = _conv_bn(p, f"{n}.branch3x3_1", x)
    b3 = _conv_bn(p, f"{n}.branch3x3_2", b3, stride=2)
    b7 = _conv_bn(p, f"{n}.branch7x7x3_1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{n}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv_bn(p, f"{n}.branch7x7x3_4", b7, stride=2)
    return jnp.concatenate([b3, b7, _max_pool(x)], axis=-1)


def _inception_e(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b3 = _conv_bn(p, f"{n}.branch3x3_1", x)
    b3 = jnp.concatenate(
        [
            _conv_bn(p, f"{n}.branch3x3_2a", b3, padding=(0, 1)),
            _conv_bn(p, f"{n}.branch3x3_2b", b3, padding=(1, 0)),
        ],
        axis=-1,
    )
    bd = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = jnp.concatenate(
        [
            _conv_bn(p, f"{n}.branch3x3dbl_3a", bd, padding=(0, 1)),
            _conv_bn(p, f"{n}.branch3x3dbl_3b", bd, padding=(1, 0)),
        ],
        axis=-1,
    )
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return jnp.concatenate([b1, b3, bd, bp], axis=-1)


# --------------------------------------------------------------------------
# full network
# --------------------------------------------------------------------------


def inception_v3_blocks(params: Dict[str, jax.Array], x: jax.Array):
    """Forward pass exposing every block output: returns ``(logits,
    {block_name: activation})``.  The per-block dict is what the golden
    tests pin — a wrong stride/padding/branch order in ANY block changes
    that block's shape or checksum and fails loudly."""
    blocks = {}

    def rec(name, v):
        blocks[name] = v
        return v

    x = rec("Conv2d_1a_3x3", _conv_bn(params, "Conv2d_1a_3x3", x, stride=2))
    x = rec("Conv2d_2a_3x3", _conv_bn(params, "Conv2d_2a_3x3", x))
    x = rec("Conv2d_2b_3x3", _conv_bn(params, "Conv2d_2b_3x3", x, padding=1))
    x = rec("maxpool1", _max_pool(x))
    x = rec("Conv2d_3b_1x1", _conv_bn(params, "Conv2d_3b_1x1", x))
    x = rec("Conv2d_4a_3x3", _conv_bn(params, "Conv2d_4a_3x3", x))
    x = rec("maxpool2", _max_pool(x))
    for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = rec(n, _inception_a(params, n, x))
    x = rec("Mixed_6a", _inception_b(params, "Mixed_6a", x))
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = rec(n, _inception_c(params, n, x))
    x = rec("Mixed_7a", _inception_d(params, "Mixed_7a", x))
    for n in ("Mixed_7b", "Mixed_7c"):
        x = rec(n, _inception_e(params, n, x))
    x = jnp.mean(x, axis=(1, 2))  # adaptive avg pool to 1x1
    logits = x @ params["fc.weight"].T + params["fc.bias"]
    return logits, blocks


def inception_v3_logits(params: Dict[str, jax.Array], x: jax.Array) -> jax.Array:
    """``x``: [B, 299, 299, 3] already ImageNet-normalized.  Returns
    [B, 1000] logits (aux head omitted — inference only)."""
    logits, _ = inception_v3_blocks(params, x)
    return logits


def preprocess(images: jax.Array, source_range: str = "[-1,1]") -> jax.Array:
    """Resize to 299 (bilinear, like the reference's ``tf.image.resize``) and
    ImageNet-normalize.  ``images``: [B, H, W, 3] float."""
    x = images.astype(jnp.float32)
    if source_range == "[-1,1]":
        x = (x + 1.0) * 0.5
    b = x.shape[0]
    x = jax.image.resize(x, (b, 299, 299, 3), "bilinear")
    return (x - _MEAN) / _STD


def make_logits_fn(params: Dict[str, jax.Array], source_range: str = "[-1,1]"):
    """A ``logits_fn`` for :func:`evals.inception.inception_score`: accepts
    flat [B, 3072] HWC CIFAR samples or [B, H, W, 3] images."""
    params = {k: jnp.asarray(v) for k, v in params.items()}

    def logits_fn(imgs):
        if imgs.ndim == 2:  # HWC-flat CIFAR layout
            n = int(round((imgs.shape[-1] // 3) ** 0.5))
            imgs = imgs.reshape(-1, n, n, 3)
        return inception_v3_logits(params, preprocess(imgs, source_range))

    return logits_fn


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """Load a torchvision-named state dict from ``.npz`` or pickle; strips
    the unused aux head and num_batches_tracked counters."""
    if path.endswith(".npz"):
        raw = dict(np.load(path))
    else:
        with open(path, "rb") as f:
            raw = pickle.load(f)
    return {
        k: np.asarray(v, np.float32)
        for k, v in raw.items()
        if not k.startswith("AuxLogits") and not k.endswith("num_batches_tracked")
    }


def find_weights(data_dir: str) -> str | None:
    """The documented drop-in location: ``<data_dir>/inception_v3.npz`` (or
    ``.pkl``); returns the path when present."""
    for name in ("inception_v3.npz", "inception_v3.pkl"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


# --------------------------------------------------------------------------
# architecture spec: every weight the loader expects, with shapes.  Used by
# tests to build random-weight state dicts and to validate real ones.
# --------------------------------------------------------------------------


def _spec_conv(d, name, cin, cout, kh, kw):
    d[f"{name}.conv.weight"] = (cout, cin, kh, kw)
    for suffix in ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
        d[f"{name}.{suffix}"] = (cout,)


@functools.lru_cache(None)
def weight_spec() -> Dict[str, tuple]:
    d: Dict[str, tuple] = {}
    _spec_conv(d, "Conv2d_1a_3x3", 3, 32, 3, 3)
    _spec_conv(d, "Conv2d_2a_3x3", 32, 32, 3, 3)
    _spec_conv(d, "Conv2d_2b_3x3", 32, 64, 3, 3)
    _spec_conv(d, "Conv2d_3b_1x1", 64, 80, 1, 1)
    _spec_conv(d, "Conv2d_4a_3x3", 80, 192, 3, 3)
    cin = 192
    for n, pool in (("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)):
        _spec_conv(d, f"{n}.branch1x1", cin, 64, 1, 1)
        _spec_conv(d, f"{n}.branch5x5_1", cin, 48, 1, 1)
        _spec_conv(d, f"{n}.branch5x5_2", 48, 64, 5, 5)
        _spec_conv(d, f"{n}.branch3x3dbl_1", cin, 64, 1, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_2", 64, 96, 3, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3", 96, 96, 3, 3)
        _spec_conv(d, f"{n}.branch_pool", cin, pool, 1, 1)
        cin = 64 + 64 + 96 + pool
    # Mixed_6a (B): in 288 -> 384 + 96 + 288 = 768
    _spec_conv(d, "Mixed_6a.branch3x3", cin, 384, 3, 3)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_1", cin, 64, 1, 1)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)
    cin = 384 + 96 + cin
    for n, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        _spec_conv(d, f"{n}.branch1x1", cin, 192, 1, 1)
        _spec_conv(d, f"{n}.branch7x7_1", cin, c7, 1, 1)
        _spec_conv(d, f"{n}.branch7x7_2", c7, c7, 1, 7)
        _spec_conv(d, f"{n}.branch7x7_3", c7, 192, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_1", cin, c7, 1, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_2", c7, c7, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_3", c7, c7, 1, 7)
        _spec_conv(d, f"{n}.branch7x7dbl_4", c7, c7, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_5", c7, 192, 1, 7)
        _spec_conv(d, f"{n}.branch_pool", cin, 192, 1, 1)
        cin = 192 * 4
    # Mixed_7a (D): 768 -> 320 + 192 + 768 = 1280
    _spec_conv(d, "Mixed_7a.branch3x3_1", cin, 192, 1, 1)
    _spec_conv(d, "Mixed_7a.branch3x3_2", 192, 320, 3, 3)
    _spec_conv(d, "Mixed_7a.branch7x7x3_1", cin, 192, 1, 1)
    _spec_conv(d, "Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    _spec_conv(d, "Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    _spec_conv(d, "Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)
    cin = 320 + 192 + cin
    for n in ("Mixed_7b", "Mixed_7c"):
        _spec_conv(d, f"{n}.branch1x1", cin, 320, 1, 1)
        _spec_conv(d, f"{n}.branch3x3_1", cin, 384, 1, 1)
        _spec_conv(d, f"{n}.branch3x3_2a", 384, 384, 1, 3)
        _spec_conv(d, f"{n}.branch3x3_2b", 384, 384, 3, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_1", cin, 448, 1, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_2", 448, 384, 3, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3a", 384, 384, 1, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3b", 384, 384, 3, 1)
        _spec_conv(d, f"{n}.branch_pool", cin, 192, 1, 1)
        cin = 320 + 768 + 768 + 192
    d["fc.weight"] = (1000, 2048)
    d["fc.bias"] = (1000,)
    return d


def validate_weights(params: Dict[str, np.ndarray]):
    """Raise with a precise message when a state dict does not match the
    architecture (missing keys / wrong shapes)."""
    spec = weight_spec()
    missing = sorted(set(spec) - set(params))
    if missing:
        raise ValueError(f"inception_v3 weights missing {len(missing)} keys, e.g. {missing[:5]}")
    for k, shape in spec.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"inception_v3 weight {k}: expected {shape}, got {params[k].shape}")


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Shape-correct random state dict (tests / dry runs without weights)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, shape in weight_spec().items():
        if k.endswith("running_var"):
            out[k] = np.abs(rs.randn(*shape)).astype(np.float32) + 0.5
        elif k.endswith("bn.weight"):
            out[k] = np.ones(shape, np.float32)
        elif k.endswith(("bn.bias", "running_mean")):
            out[k] = (0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            out[k] = (0.05 * rs.randn(*shape)).astype(np.float32)
    return out
