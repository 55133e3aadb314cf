"""Functional parameter/state container for jit-compiled model code.

The reference (tkkiran/Robust-Conditional-GAN) relies on TF1 variable scopes
with hidden side effects: spectral-norm ``u`` vectors updated through control
dependencies (``mnist/sn.py:44-62``), batch-norm moving statistics updated via
``updates_collections=None`` (``mnist/ops.py:30-44``), and a trainable
confusion matrix (``mnist/model.py:102-106``).  Here all of that state is
explicit so a whole G/D/C training cycle compiles to one XLA program.

``Ctx`` is that explicit container.  Model code is written once as plain
functions ``f(ctx, *inputs)``; running them with ``ctx.init=True`` *creates*
parameters/state (like ``tf.get_variable`` on first call), and running with
``ctx.init=False`` *reads* them (like ``reuse=True``).  Parameters live in a
flat ``{layer_name: {var_name: array}}`` dict — a plain pytree — so
name-prefix partitioning into G/D/C optimizer groups (the reference's
``'d_' in var.name`` convention, ``mnist/model.py:244-245``;
``'Generator' in var.name``, ``cifar10/gan_resnet.py:788-793``) is a dict
comprehension, and shardings can be attached per-leaf with ``jax.sharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

Params = Dict[str, Dict[str, jax.Array]]
State = Dict[str, Dict[str, jax.Array]]


class Ctx:
    """Threaded through layer/model apply functions.

    Attributes:
      init: when True, ``param``/``stat`` create missing entries.
      params: flat ``{layer: {name: array}}`` parameter tree.
      state: non-trainable state (SN ``u`` vectors, BN moving stats). Reads
        come from here.
      new_state: state writes land here; callers merge with ``updated_state()``.
      train: training mode (batch-norm uses batch stats + updates moving ones).
      update_sn: whether spectral-norm power-iteration updates ``u``.  The
        reference freezes ``u`` during CIFAR generator steps via the
        ``NO_OPS`` collection (``cifar10/gan_resnet.py:723,729``) but updates
        it on every MNIST call (``mnist/ops.py:60``).
      compute_dtype: activations/weights are cast to this dtype at matmul/conv
        boundaries (bfloat16 for tensor-core throughput); params stay float32.
    """

    def __init__(
        self,
        params: Optional[Params] = None,
        state: Optional[State] = None,
        rng: Optional[jax.Array] = None,
        *,
        init: bool = False,
        train: bool = True,
        update_sn: bool = True,
        compute_dtype: Any = jnp.float32,
    ):
        self.init = init
        self.params: Params = {} if params is None else params
        self.state: State = {} if state is None else state
        self.new_state: State = {}
        self.train = train
        self.update_sn = update_sn
        self.compute_dtype = compute_dtype
        # Post-update clip constraints registered at init time (TF's
        # ``tf.get_variable(constraint=...)``, ``mnist/ops.py:102-111``):
        # {layer: {var: (lo, hi)}}; the optimizer applies them after each step.
        self.constraints: Dict[str, Dict[str, Any]] = {}
        self._rng = rng
        self._rng_counter = 0

    # ---------------------------------------------------------------- rng
    def next_rng(self) -> jax.Array:
        if self._rng is None:
            raise ValueError("Ctx was constructed without an rng key")
        self._rng_counter += 1
        return jax.random.fold_in(self._rng, self._rng_counter)

    def name_rng(self, layer: str, name: str) -> jax.Array:
        """Deterministic per-variable key: stable under call-order changes."""
        if self._rng is None:
            raise ValueError("Ctx was constructed without an rng key")
        seed = _stable_hash(f"{layer}/{name}")
        return jax.random.fold_in(self._rng, seed)

    # ------------------------------------------------------------- params
    def param(
        self,
        layer: str,
        name: str,
        shape,
        init_fn: Callable[[jax.Array, Any, Any], jax.Array],
        dtype=jnp.float32,
    ) -> jax.Array:
        if self.init:
            d = self.params.setdefault(layer, {})
            if name not in d:
                d[name] = init_fn(self.name_rng(layer, name), tuple(shape), dtype)
            return d[name]
        try:
            return self.params[layer][name]
        except KeyError as e:
            raise KeyError(
                f"Missing parameter {layer}/{name}; available layers: "
                f"{sorted(self.params)[:20]}..."
            ) from e

    def has_param(self, layer: str) -> bool:
        return layer in self.params

    # -------------------------------------------------------------- state
    def stat(
        self,
        layer: str,
        name: str,
        shape,
        init_fn: Callable[[jax.Array, Any, Any], jax.Array],
        dtype=jnp.float32,
    ) -> jax.Array:
        """Read non-trainable state, creating it in init mode.

        Reads prefer a value written earlier in this same trace
        (``new_state``) so sequential calls chain, matching TF control
        dependencies that serialize ``u.assign`` ops.
        """
        if layer in self.new_state and name in self.new_state[layer]:
            return self.new_state[layer][name]
        if self.init:
            d = self.state.setdefault(layer, {})
            if name not in d:
                d[name] = init_fn(self.name_rng(layer, name), tuple(shape), dtype)
            return d[name]
        return self.state[layer][name]

    def put_stat(self, layer: str, name: str, value: jax.Array) -> None:
        if self.init:
            # Init traces create variables but must not apply update ops —
            # TF variables come out of init at their initial values.
            return
        self.new_state.setdefault(layer, {})[name] = value

    def updated_state(self) -> State:
        """State dict with this trace's writes merged over the input state."""
        out = {k: dict(v) for k, v in self.state.items()}
        for layer, d in self.new_state.items():
            out.setdefault(layer, {}).update(d)
        return out


import contextlib


@contextlib.contextmanager
def sn_updates(ctx: "Ctx", flag: bool):
    """Temporarily override spectral-norm ``u`` updating — the per-call
    ``update_collection`` granularity of the reference (e.g. the CIFAR G-step
    freezes D's conv ``u``s but still updates the projection head's,
    ``cifar10/gan_resnet.py:721-731``)."""
    old = ctx.update_sn
    ctx.update_sn = flag
    try:
        yield
    finally:
        ctx.update_sn = old


def _stable_hash(s: str) -> int:
    """Deterministic 31-bit string hash (Python's hash() is salted)."""
    h = 0
    for ch in s.encode():
        h = (h * 31 + ch) & 0x7FFFFFFF
    return h


@dataclasses.dataclass
class Transformed:
    """init/apply pair produced by :func:`transform` (haiku-style)."""

    init: Callable
    apply: Callable
    init_full: Optional[Callable] = None


def transform(f: Callable) -> Transformed:
    """Lift ``f(ctx, *args, **kwargs)`` into pure init/apply functions.

    ``init(rng, *args)`` returns ``(params, state)``.
    ``apply(params, state, rng, *args, train=..., update_sn=..., compute_dtype=...)``
    returns ``(out, new_state)``.
    """

    def init_fn(rng, *args, **kwargs):
        static = {k: kwargs.pop(k) for k in ("train", "update_sn", "compute_dtype") if k in kwargs}
        ctx = Ctx(rng=rng, init=True, **static)
        f(ctx, *args, **kwargs)
        return ctx.params, ctx.updated_state()

    def init_full_fn(rng, *args, **kwargs):
        """Like init, but also returns the registered clip constraints."""
        static = {k: kwargs.pop(k) for k in ("train", "update_sn", "compute_dtype") if k in kwargs}
        ctx = Ctx(rng=rng, init=True, **static)
        f(ctx, *args, **kwargs)
        return ctx.params, ctx.updated_state(), ctx.constraints

    def apply_fn(params, state, rng, *args, **kwargs):
        static = {k: kwargs.pop(k) for k in ("train", "update_sn", "compute_dtype") if k in kwargs}
        ctx = Ctx(params=params, state=state, rng=rng, init=False, **static)
        out = f(ctx, *args, **kwargs)
        return out, ctx.updated_state()

    return Transformed(init_fn, apply_fn, init_full_fn)


# ----------------------------------------------------------------- trees
def split_by_prefix(params: Params, groups: Dict[str, Callable[[str], bool]]):
    """Partition a flat param dict into named groups by layer-name predicate.

    Mirrors the reference's optimizer var partition:
    ``mnist/model.py:242-245`` (``'d_' in name`` / ``'g_' in name``) and
    ``cifar10/gan_resnet.py:788-800``.
    """
    out = {g: {} for g in groups}
    for layer, vs in params.items():
        for gname, pred in groups.items():
            if pred(layer):
                out[gname][layer] = vs
                break
        else:
            raise ValueError(f"layer {layer!r} matched no param group")
    return out


def merge(*trees: Params) -> Params:
    out: Params = {}
    for t in trees:
        for layer, vs in t.items():
            out.setdefault(layer, {}).update(vs)
    return out


def count_params(params: Params) -> int:
    return sum(x.size for d in params.values() for x in d.values())
