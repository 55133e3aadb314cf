"""MS-SSIM image similarity (reference CLI: ``cifar10/common/msssim.py``,
Wang et al. multi-scale SSIM with the standard 5-level weights), implemented
with XLA convs so it jit-compiles on any backend.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss(size: int, sigma: float) -> jnp.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return jnp.asarray(k / k.sum(), jnp.float32)


def _filter2(img: jnp.ndarray, window: jnp.ndarray) -> jnp.ndarray:
    """'valid' 2-D filtering applied per channel; img [B,H,W,C]."""
    c = img.shape[-1]
    w = jnp.tile(window[:, :, None, None], (1, 1, 1, c))  # HWIO depthwise
    return jax.lax.conv_general_dilated(
        img, w, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
    )


def ssim_per_image(img1, img2, max_val: float = 255.0, filter_size: int = 11,
                   filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Returns ([B] SSIM, [B] contrast-structure) for [B,H,W,C] image pairs
    (spatial/channel mean only — the batch axis stays separate, so callers
    can aggregate per-pair statistics; :func:`ssim` is its batch mean)."""
    img1 = jnp.asarray(img1, jnp.float32)
    img2 = jnp.asarray(img2, jnp.float32)
    h, w = img1.shape[1:3]
    size = min(filter_size, h, w)
    sigma = size * filter_sigma / filter_size if filter_size else 0

    if size:
        window = _fspecial_gauss(size, sigma)
        mu1, mu2 = _filter2(img1, window), _filter2(img2, window)
        sigma11 = _filter2(img1 * img1, window)
        sigma22 = _filter2(img2 * img2, window)
        sigma12 = _filter2(img1 * img2, window)
    else:
        mu1, mu2 = img1, img2
        sigma11, sigma22, sigma12 = img1 * img1, img2 * img2, img1 * img2

    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma11 = sigma11 - mu11
    sigma22 = sigma22 - mu22
    sigma12 = sigma12 - mu12

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    axes = (1, 2, 3)
    s = jnp.mean((2.0 * mu12 + c1) * v1 / ((mu11 + mu22 + c1) * v2), axis=axes)
    cs = jnp.mean(v1 / v2, axis=axes)
    return s, cs


def ssim(img1, img2, max_val: float = 255.0, filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03):
    """Returns (mean SSIM, mean contrast-structure) for [B,H,W,C] images."""
    s, cs = ssim_per_image(img1, img2, max_val, filter_size, filter_sigma, k1, k2)
    return jnp.mean(s), jnp.mean(cs)


def _downsample2(img):
    """2x average-pool with SAME-style reflect of odd edges (simple crop)."""
    b, h, w, c = img.shape
    img = img[:, : h - h % 2, : w - w % 2, :]
    return 0.25 * (
        img[:, ::2, ::2] + img[:, 1::2, ::2] + img[:, ::2, 1::2] + img[:, 1::2, 1::2]
    )


def msssim(img1, img2, max_val: float = 255.0, weights=_WEIGHTS) -> float:
    """Multi-scale SSIM over ``len(weights)`` dyadic scales."""
    img1 = jnp.asarray(img1, jnp.float32)
    img2 = jnp.asarray(img2, jnp.float32)
    mssim, mcs = [], []
    for _ in weights:
        s, cs = ssim(img1, img2, max_val=max_val)
        mssim.append(s)
        mcs.append(cs)
        img1, img2 = _downsample2(img1), _downsample2(img2)
    # clamp at 0 before the fractional powers: cs can go negative for very
    # dissimilar pairs, and (negative)**0.0448 is NaN (the tf.image
    # ssim_multiscale relu convention)
    mssim = jnp.maximum(jnp.stack(mssim), 0.0)
    mcs = jnp.maximum(jnp.stack(mcs), 0.0)
    w = jnp.asarray(weights)
    return float(jnp.prod(mcs[:-1] ** w[:-1]) * (mssim[-1] ** w[-1]))


def msssim_pairs(img1, img2, max_val: float = 255.0, weights=_WEIGHTS) -> jnp.ndarray:
    """Per-pair multi-scale SSIM, batched: [B,H,W,C] × [B,H,W,C] → [B].

    The per-pair values let callers report pairwise-similarity
    *distributions* — the mean intra-class MS-SSIM diversity protocol
    (Odena et al. 2017) the reference vendors its ``msssim.py`` CLI for
    (``cifar10/common/msssim.py``) — where :func:`msssim`'s scalar
    (products of batch-mean scale factors) would conflate the pairs."""
    img1 = jnp.asarray(img1, jnp.float32)
    img2 = jnp.asarray(img2, jnp.float32)
    mssim, mcs = [], []
    for _ in weights:
        s, cs = ssim_per_image(img1, img2, max_val=max_val)
        mssim.append(s)
        mcs.append(cs)
        img1, img2 = _downsample2(img1), _downsample2(img2)
    # same relu-before-power convention as :func:`msssim`
    mssim = jnp.maximum(jnp.stack(mssim), 0.0)  # [scale, B]
    mcs = jnp.maximum(jnp.stack(mcs), 0.0)
    w = jnp.asarray(weights)[:, None]
    return jnp.prod(mcs[:-1] ** w[:-1], axis=0) * (mssim[-1] ** w[-1, 0])


def _main():
    """CLI parity with ``python msssim.py --original_image a.png
    --compared_image b.png`` (``cifar10/common/msssim.py:36-218``)."""
    import argparse

    import numpy as np
    from PIL import Image

    p = argparse.ArgumentParser(description="MS-SSIM between two images")
    p.add_argument("--original_image", required=True)
    p.add_argument("--compared_image", required=True)
    args = p.parse_args()
    a = np.asarray(Image.open(args.original_image).convert("RGB"), np.float32)[None]
    b = np.asarray(Image.open(args.compared_image).convert("RGB"), np.float32)[None]
    if a.shape != b.shape:
        raise SystemExit(f"image shapes differ: {a.shape[1:3]} vs {b.shape[1:3]}")
    print(msssim(a, b))


if __name__ == "__main__":
    _main()
