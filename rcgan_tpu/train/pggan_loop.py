"""Progressive-growing GAN trainer — activates the PGGAN model family.

The reference vendors PGGAN G/D blocks with fade-in but never trains them
(``cifar10/common/resnet_block.py:192-349`` — dead library surface).  This
trainer supplies the missing schedule, compile-once:

- **All stages' parameters are materialized up front** (one init pass per
  (stage, trans) phase): the parameter tree is static across the whole
  progressive run, so each phase is ONE jitted program and phase
  transitions never reshape optimizer state.  Parameters of not-yet-active
  blocks receive zero gradient and Adam leaves them untouched.
- **``alpha`` is a traced scalar**: the fade-in ramp costs zero recompiles.
- **Per-stage data**: the 32x32 stream is average-pooled on device to the
  stage resolution (PGGAN feeds the current resolution).
- Phase schedule per stage ``s`` > 1: transition (alpha 0 -> 1 over
  ``trans_iters``), then stabilization (``stab_iters``); stage 1 has no
  transition.  1 D step + 1 G step per iteration, hinge loss by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu.core.module import Ctx, merge
from rcgan_tpu.algorithms.losses import get_loss
from rcgan_tpu.core.rng import example_normal
from rcgan_tpu.models.pggan import PGGANConfig, discriminator, generator
from rcgan_tpu.models.resnet_gan import ResnetGANConfig
from rcgan_tpu.train.state import (
    TrainState,
    apply_updates_with_lr,
    init_train_state,
    scaleless_adam,
)


@dataclasses.dataclass(frozen=True)
class PGGANTrainConfig:
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.99
    trans_iters: int = 600
    stab_iters: int = 600
    loss_type: str = "HINGE"


def pool_to_stage(x: jax.Array, cfg: PGGANConfig, stage: int) -> jax.Array:
    """[B, H, W, C] at full resolution -> stage resolution by avg-pooling
    (H = base * 2^max_stage assumed)."""
    target = cfg.base_size * (2**stage)
    factor = x.shape[1] // target
    if factor <= 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, target, factor, target, factor, c).mean(axis=(2, 4))


class PGGANTrainer:
    """Progressive schedule over a statically-materialized parameter tree."""

    def __init__(
        self,
        cfg: PGGANConfig,
        base: ResnetGANConfig,
        tcfg: PGGANTrainConfig,
        compute_dtype=jnp.float32,
    ):
        self.cfg, self.base, self.tcfg = cfg, base, tcfg
        self.compute_dtype = compute_dtype
        adam = lambda: scaleless_adam(tcfg.beta1, tcfg.beta2)
        self.optimizers = {"gen": adam(), "disc": adam()}
        self._steps = {}

    # ------------------------------------------------------------- build
    def init(self, rng: jax.Array, batch: int) -> TrainState:
        """Materialize EVERY stage's parameters (incl. per-stage To/FromRGB
        and transition shortcuts) in one tree."""
        cfg = self.cfg
        ctx = Ctx(rng=rng, init=True, compute_dtype=self.compute_dtype)
        z = jnp.zeros((batch, cfg.z_dim), jnp.float32)
        labels = jnp.zeros((batch,), jnp.int32)
        d_labels = labels if cfg.conditional else None
        for stage in range(1, cfg.max_stage + 1):
            for trans in ((False,) if stage == 1 else (False, True)):
                fake = generator(ctx, cfg, self.base, z, labels, stage, trans, 0.5)
                discriminator(ctx, cfg, self.base, fake, stage, trans, 0.5,
                              labels=d_labels)
        preds = {
            "gen": lambda n: n.startswith("PG.G."),
            "disc": lambda n: n.startswith("PG.D."),
        }
        return init_train_state(ctx.params, ctx.updated_state(), preds, self.optimizers)

    # -------------------------------------------------------------- step
    def _step(self, ts: TrainState, images: dict, rng, alpha, *, stage: int, trans: bool):
        cfg, base, tcfg = self.cfg, self.base, self.tcfg
        x = pool_to_stage(images["x"], cfg, stage).astype(self.compute_dtype)
        labels = images["labels"]
        # conditional critic: the projection head sees the batch's labels on
        # BOTH the real pass and the fake pass (fakes are generated from the
        # same labels), exactly the main stack's pairing (gan_resnet.py:588)
        d_labels = labels if cfg.conditional else None
        b = x.shape[0]
        z = example_normal(jax.random.fold_in(rng, 0), b, cfg.z_dim)

        groups = dict(ts.groups)
        state = ts.state
        opt_states = dict(ts.opt_states)

        def d_loss_fn(d_params, state):
            ctx = Ctx(params=merge(groups["gen"], d_params), state=state, rng=None,
                      init=False, train=True, update_sn=True, compute_dtype=self.compute_dtype)
            fake = generator(ctx, cfg, base, z, labels, stage, trans, alpha)
            _, d_fake = discriminator(ctx, cfg, base, fake, stage, trans, alpha,
                                      labels=d_labels)
            _, d_real = discriminator(ctx, cfg, base, x, stage, trans, alpha,
                                      labels=d_labels)
            _, d_cost = get_loss(d_real, d_fake, tcfg.loss_type)
            return d_cost, (d_cost, ctx.updated_state())

        (_, (d_cost, state)), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
            groups["disc"], state
        )
        d_upd, opt_states["disc"] = self.optimizers["disc"].update(
            d_grads, opt_states["disc"], groups["disc"]
        )
        groups["disc"] = apply_updates_with_lr(groups["disc"], d_upd, tcfg.lr)

        def g_loss_fn(g_params, state):
            ctx = Ctx(params=merge(g_params, groups["disc"]), state=state, rng=None,
                      init=False, train=True, update_sn=False, compute_dtype=self.compute_dtype)
            fake = generator(ctx, cfg, base, z, labels, stage, trans, alpha)
            _, d_fake = discriminator(ctx, cfg, base, fake, stage, trans, alpha,
                                      labels=d_labels)
            g_cost, _ = get_loss(jnp.zeros_like(d_fake), d_fake, tcfg.loss_type)
            return g_cost, (g_cost, ctx.updated_state())

        (_, (g_cost, state)), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(
            groups["gen"], state
        )
        g_upd, opt_states["gen"] = self.optimizers["gen"].update(
            g_grads, opt_states["gen"], groups["gen"]
        )
        groups["gen"] = apply_updates_with_lr(groups["gen"], g_upd, tcfg.lr)

        new_ts = TrainState(groups=groups, state=state, opt_states=opt_states, step=ts.step + 1)
        return new_ts, {"d_cost": d_cost, "g_cost": g_cost}

    def step(self, ts, images, rng, alpha, stage: int, trans: bool):
        """One D + one G update at (stage, trans); ``alpha`` is traced."""
        key = (stage, trans)
        if key not in self._steps:
            import functools

            self._steps[key] = jax.jit(
                functools.partial(self._step, stage=stage, trans=trans), donate_argnums=0
            )
        return self._steps[key](ts, images, rng, jnp.asarray(alpha, jnp.float32))

    # ---------------------------------------------------------- schedule
    def phases(self):
        """Yields (stage, trans, n_iters) in PGGAN order."""
        for stage in range(1, self.cfg.max_stage + 1):
            if stage > 1:
                yield stage, True, self.tcfg.trans_iters
            yield stage, False, self.tcfg.stab_iters

    def train_progressive(
        self,
        ts: TrainState,
        data_fn,
        rng: jax.Array,
        log_fn=None,
        iters_scale: float = 1.0,
        progress_every: int = 0,
        progress_fn=None,
        ckpt=None,
    ) -> TrainState:
        """Run the full progressive schedule.  ``data_fn(it) -> {'x': [B,
        H, W, C] full-res float in [-1, 1], 'labels': [B] int32}``.

        ``progress_every`` > 0 calls ``progress_fn(stage, trans, it, alpha,
        metrics, ts)`` every that-many iterations WITHIN a phase (a device
        sync; for diagnostics, off by default).

        ``ckpt``: optional :class:`train.checkpoint.Checkpointer`.  The
        state is saved at every phase boundary (blocking — boundaries are
        rare), and a RESTORED ``ts`` resumes mid-schedule: the phase plan
        is deterministic, so ``int(ts.step)`` locates the exact next
        iteration (the reference's latest-checkpoint auto-resume behavior,
        ``gan_resnet.py:905-914``, extended to the progressive schedule).
        Per-iteration RNG is derived by ``fold_in(rng, global_it)`` — index
        keyed, not split-chained — so a resumed run's remaining iterations
        see bit-identical keys and a crash-resume trajectory matches the
        uninterrupted one whenever ``data_fn`` is a pure function of the
        iteration index."""
        start = int(ts.step)
        it = 0
        for stage, trans, n in self.phases():
            n = max(1, int(n * iters_scale))
            if it + n <= start:  # phase fully covered by the restored state
                it += n
                continue
            stepped = False
            for i in range(n):
                if it < start:  # partial phase: fast-forward to the next iter
                    it += 1
                    continue
                alpha = (i + 1) / n if trans else 1.0
                sub = jax.random.fold_in(rng, it)
                ts, m = self.step(ts, data_fn(it), sub, alpha, stage, trans)
                it += 1
                stepped = True
                if progress_every and progress_fn is not None and i % progress_every == 0:
                    progress_fn(stage, trans, it, alpha,
                                {k: float(v) for k, v in m.items()}, ts)
            if log_fn is not None and stepped:
                # the live ts is passed because the per-phase jitted step
                # DONATES its input state — callers must not sample from a
                # stale reference
                log_fn(stage, trans, it, {k: float(v) for k, v in m.items()}, ts)
            if ckpt is not None and stepped:
                ckpt.save(it, ts, wait=True)
        return ts

    # ------------------------------------------------------------ sample
    def sample(self, ts: TrainState, z: jax.Array, labels: jax.Array,
               stage: Optional[int] = None) -> jax.Array:
        stage = self.cfg.max_stage if stage is None else stage
        ctx = Ctx(params=merge(*ts.groups.values()), state=ts.state, rng=None,
                  init=False, train=True, update_sn=False, compute_dtype=self.compute_dtype)
        return generator(ctx, self.cfg, self.base, z, labels, stage, False, 1.0)
