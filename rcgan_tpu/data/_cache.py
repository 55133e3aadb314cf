"""On-disk memoization for the deterministic synthetic dataset renderers.

The synthetic stand-in datasets (``cifar10.synthetic_cifar``,
``mnist.synthetic_digits``) are pure functions of their arguments, but
rendering is host-side numpy work that runs at the start of EVERY
experiment: ~33 s for 50k 32px images, ~17 s for the 70k digit set, and
~3.4 min for 20k 128px images.  Sweep drivers re-render the identical
arrays once per cell.

This module caches the rendered arrays as uncompressed ``.npz`` files
(bit-exact uint8/int64 round-trip, ~1 s to load) keyed by:

- every argument that affects the output (including ``chunk`` — the
  per-chunk RNG draws make the image stream chunk-dependent), and
- a digest of the renderer's compiled code (``marshal`` of the function's
  code object, which covers constants), so editing the renderer
  invalidates stale entries without manual version bumps.

Location: ``$RCGAN_SYNTH_CACHE`` (set to ``0``/``off``/empty to disable),
default ``<repo>/.synth_cache`` (git-ignored).  Writes are atomic (temp file +
``os.replace``), so concurrent runs at worst render twice.
"""

from __future__ import annotations

import hashlib
import marshal
import os
import tempfile

import numpy as np

_DISABLED = ("", "0", "off", "none")


def cache_dir() -> str | None:
    d = os.environ.get("RCGAN_SYNTH_CACHE")
    if d is None:
        d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".synth_cache")
    return None if d.strip().lower() in _DISABLED else d


def _code_digest(fn) -> str:
    return hashlib.sha1(marshal.dumps(fn.__code__)).hexdigest()[:10]


def memoize_render(name: str, key: dict, render, code_of=None):
    """Return ``render()``'s tuple of numpy arrays, served from / saved to
    the cache when enabled.  ``render`` must be a deterministic function of
    ``key``; the code object of ``code_of`` (default: ``render`` itself —
    pass the underlying renderer when ``render`` is a closure over it) is
    part of the cache key."""
    d = cache_dir()
    if d is None:
        return render()
    parts = "_".join(f"{k}{key[k]}" for k in sorted(key))
    path = os.path.join(d, f"{name}_{parts}_{_code_digest(code_of or render)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return tuple(z[f"arr_{i}"] for i in range(len(z.files)))
        except Exception:
            pass  # truncated/corrupt entry (e.g. killed writer pre-replace): re-render
    arrays = tuple(render())
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        np.savez(tmp, *arrays)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only/full cache volume: caching is best-effort
    return arrays
