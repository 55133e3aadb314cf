"""CIFAR fused training cycle: (1 G step + C step) then N_CRITIC D steps
compiled as ONE XLA program per iteration (reference hot loop
``cifar10/gan_resnet.py:916-947`` issued 6 feed_dict ``sess.run``s).

Data parallelism is shard_map over a 1-D ``('data',)`` mesh: each device
computes its shard's losses/grads, gradients are ``pmean``-averaged across
devices, and identical updates keep params replicated — the SPMD equivalent
of the reference's two-tower in-graph replication + shared variables
(``gan_resnet.py:183-192,529-546,557-584,697``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from rcgan_tpu.core.module import Ctx, merge
from rcgan_tpu.algorithms.cifar import (
    CifarAlgoConfig,
    disc_loss,
    gen_loss,
    lr_decay,
    partition_predicates,
)
from rcgan_tpu.core.rng import example_keys, example_normal
from rcgan_tpu.data.cifar10 import dequantize_chw_to_hwc, dequantize_chw_to_hwc_keys
from rcgan_tpu.models.resnet_gan import ResnetGANConfig, generator
from rcgan_tpu.train.state import (
    TrainState,
    apply_updates_with_lr,
    init_train_state,
    scaleless_adam,
)


@dataclasses.dataclass(frozen=True)
class CifarTrainConfig:
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    n_critic: int = 5
    gen_bs_multiple: int = 2
    decay: bool = True
    confuse_multiplier: float = 1.0
    confuse_lr_decay: bool = False
    # optional low-precision Adam-moment storage ("bfloat16"): halves the
    # optimizer tail's HBM traffic; None = reference-faithful float32
    moment_dtype: Optional[str] = None


class CifarTrainer:
    """Builds params and the jitted (optionally sharded) train cycle."""

    def __init__(
        self,
        cfg: ResnetGANConfig,
        acfg: CifarAlgoConfig,
        tcfg: CifarTrainConfig,
        confusion_actual: np.ndarray,
        mesh: Optional[Mesh] = None,
        compute_dtype=jnp.float32,
        device_dataset: Optional[dict] = None,
    ):
        """``device_dataset``: optional dict of full-dataset arrays
        (images/labels/labels_random/labels_biased/labels_inv_weights) kept
        resident in device memory (CIFAR-10 is ~150 MB as uint8).  The step
        then takes int32 INDEX batches and gathers on device — eliminating
        the per-iteration host→device copy that dominated the reference's
        loop (SURVEY §3)."""
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.confusion_actual = jnp.asarray(confusion_actual, jnp.float32)
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.device_dataset = device_dataset
        if device_dataset is not None:
            self.device_dataset = {k: jnp.asarray(v) for k, v in device_dataset.items()}
        adam = lambda: scaleless_adam(tcfg.beta1, tcfg.beta2, moment_dtype=tcfg.moment_dtype)
        self.optimizers = {"disc": adam(), "gen": adam(), "confusion": adam()}

    # ------------------------------------------------------------- build
    def init(self, rng: jax.Array, batch_size: int) -> TrainState:
        ctx = Ctx(rng=rng, init=True, compute_dtype=self.compute_dtype)
        n = batch_size if self.mesh is None else batch_size // self.mesh.devices.size
        dummy = {
            "real_data": jnp.zeros((n, self.cfg.output_dim), jnp.float32),
            "labels": jnp.zeros((n,), jnp.int32),
            "labels_random": jnp.zeros((n,), jnp.int32),
            "labels_biased": jnp.zeros((n,), jnp.int32),
            "labels_inv_weights": jnp.zeros((n, self.cfg.vocab_size), jnp.float32),
        }
        z = jnp.zeros((n, self.cfg.z_dim), jnp.float32)
        disc_loss(ctx, self.cfg, self.acfg, dummy, z, self.confusion_actual)
        zg = jnp.zeros((n * self.tcfg.gen_bs_multiple, self.cfg.z_dim), jnp.float32)
        gen_loss(ctx, self.cfg, self.acfg, dummy["labels_random"].repeat(self.tcfg.gen_bs_multiple),
                 dummy["labels_biased"].repeat(self.tcfg.gen_bs_multiple), zg, self.confusion_actual)
        preds = partition_predicates()
        if self.acfg.algorithm != "rcgan-u":
            preds = {k: v for k, v in preds.items() if k != "confusion"}
        return init_train_state(ctx.params, ctx.updated_state(), preds, self.optimizers)

    # ------------------------------------------------------- cycle body
    def _cycle(self, ts: TrainState, d_batches: dict, g_labels: dict, iteration, rng,
               axis=None, dataset=None, static_unroll=False):
        """Body run per device-shard.  ``d_batches`` leaves have leading dim
        [n_critic, local_b]; ``g_labels`` leaves [gen_bs_multiple*local_b].
        ``axis``: mesh axis name when running under shard_map, else None.

        ``static_unroll``: emit the steady-state cycle (iteration > 0) with
        Python-level control flow — the G step unconditionally and the
        n_critic D steps as straight-line code instead of ``lax.cond`` /
        ``lax.scan``.  Numerically identical to the rolled form for
        iteration > 0 (asserted in tests/test_train.py); it exists because
        XLA's ``cost_analysis()`` counts a while-loop body ONCE regardless
        of trip count (and a conditional as the max branch), so the rolled
        program under-reports per-cycle flops ~2x.  Profiling/bench code
        counts flops on this variant; the hot path stays rolled (compiles
        ~5x faster, same machine code per step).
        """
        cfg, acfg, tcfg = self.cfg, self.acfg, self.tcfg
        # All per-example noise (z, dequantization) is keyed by GLOBAL batch
        # index (core/rng.py), so the sharded cycle equals the unsharded one
        # to float tolerance — the reference's device-aliasing property
        # (gan_resnet.py:187-188) as a tight invariant.

        def pavg(tree):
            if axis is None:
                return tree
            return jax.tree_util.tree_map(lambda x: jax.lax.pmean(x, axis), tree)

        decay = lr_decay(iteration, tcfg.decay)
        lr = tcfg.lr * decay
        confuse_lr = tcfg.lr * tcfg.confuse_multiplier * (decay if tcfg.confuse_lr_decay else 1.0)

        groups = dict(ts.groups)
        state = ts.state
        opt_states = dict(ts.opt_states)
        has_c = "confusion" in groups

        # ---------------- G step (+ C step), skipped at iteration 0
        # (gan_resnet.py:928-934).
        def g_step(operand):
            groups, state, opt_states = operand
            zg = example_normal(
                jax.random.fold_in(rng, 1), g_labels["random"].shape[0], cfg.z_dim, axis
            )

            def g_loss_fn(g_params, c_params, state):
                parts = [g for n, g in groups.items() if n not in ("gen", "confusion")]
                ctx = Ctx(params=merge(*parts, g_params, c_params), state=state, rng=None,
                          init=False, train=True, update_sn=True, compute_dtype=self.compute_dtype)
                out = gen_loss(ctx, cfg, acfg, g_labels["random"], g_labels["biased"], zg,
                               self.confusion_actual)
                return out["gen_cost"], (out, ctx.updated_state())

            c_group = groups.get("confusion", {})
            (_, (g_out, state)), (g_grads, c_grads) = jax.value_and_grad(
                g_loss_fn, argnums=(0, 1), has_aux=True
            )(groups["gen"], c_group, state)
            g_grads, c_grads = pavg((g_grads, c_grads))
            state = pavg(state)
            g_upd, opt_states["gen"] = self.optimizers["gen"].update(
                g_grads, opt_states["gen"], groups["gen"]
            )
            groups["gen"] = apply_updates_with_lr(groups["gen"], g_upd, lr)
            if has_c:
                c_upd, opt_states["confusion"] = self.optimizers["confusion"].update(
                    c_grads, opt_states["confusion"], c_group
                )
                groups["confusion"] = apply_updates_with_lr(c_group, c_upd, confuse_lr)
            return (groups, state, opt_states), g_out["gen_cost"]

        def g_skip(operand):
            return operand, jnp.zeros(())

        if static_unroll:
            (groups, state, opt_states), gen_cost = g_step((groups, state, opt_states))
        else:
            (groups, state, opt_states), gen_cost = jax.lax.cond(
                iteration > 0, g_step, g_skip, (groups, state, opt_states)
            )

        # ---------------- N_CRITIC D steps over distinct micro-batches
        # (gan_resnet.py:936-947), as a lax.scan inside the same program.
        def d_step(carry, inp):
            disc_params, d_opt_state, state = carry
            batch, k = inp
            if dataset is not None:
                # batch is {'index': [local_b] int32}: gather the resident
                # dataset rows on device — no host transfer on the hot path.
                # The dataset is a RUNTIME ARGUMENT, not a traced constant:
                # closing over it embeds ~600 MB in the HLO (and recompiles
                # on every new array).
                idx = batch["index"]
                batch = {k2: jnp.take(v, idx, axis=0) for k2, v in dataset.items()}
            kz, kq = jax.random.split(k)
            local_b = batch["images"].shape[0]
            q_keys = example_keys(kq, local_b, axis)
            with jax.named_scope("dequantize"):
                real = dequantize_chw_to_hwc_keys(
                    batch["images"], q_keys, cfg.img_size, cfg.img_dim
                )
            z = example_normal(kz, local_b, cfg.z_dim, axis)
            sb = {
                "real_data": real,
                "labels": batch["labels"],
                "labels_random": batch["labels_random"],
                "labels_biased": batch["labels_biased"],
                "labels_inv_weights": batch["labels_inv_weights"],
            }

            def d_loss_fn(d_params, state):
                parts = [g for n, g in groups.items() if n != "disc"]
                ctx = Ctx(params=merge(*parts, d_params), state=state, rng=None, init=False,
                          train=True, update_sn=True, compute_dtype=self.compute_dtype)
                out = disc_loss(ctx, cfg, acfg, sb, z, self.confusion_actual)
                return out["disc_cost"], (out, ctx.updated_state())

            (_, (d_out, state)), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
                disc_params, state
            )
            d_grads = pavg(d_grads)
            state = pavg(state)
            d_upd, d_opt_state = self.optimizers["disc"].update(d_grads, d_opt_state, disc_params)
            disc_params = apply_updates_with_lr(disc_params, d_upd, lr)
            return (disc_params, d_opt_state, state), d_out["disc_cost"]

        keys = jax.random.split(jax.random.fold_in(rng, 2), tcfg.n_critic)
        if static_unroll:
            carry = (groups["disc"], opt_states["disc"], state)
            d_cost_list = []
            for i in range(tcfg.n_critic):
                row = jax.tree_util.tree_map(lambda x: x[i], d_batches)
                carry, c = d_step(carry, (row, keys[i]))
                d_cost_list.append(c)
            (groups["disc"], opt_states["disc"], state) = carry
            d_costs = jnp.stack(d_cost_list)
        else:
            (groups["disc"], opt_states["disc"], state), d_costs = jax.lax.scan(
                d_step, (groups["disc"], opt_states["disc"], state), (d_batches, keys)
            )

        metrics = {
            "d_cost": d_costs[-1],
            "d_cost_mean": jnp.mean(d_costs),
            "g_cost": gen_cost,
            "lr": lr,
        }
        if axis is not None:
            metrics = {k: jax.lax.pmean(v, axis) for k, v in metrics.items()}
        new_ts = TrainState(groups=groups, state=state, opt_states=opt_states, step=ts.step + 1)
        return new_ts, metrics

    # ---------------------------------------------------------- stepping
    @functools.cached_property
    def _jitted_cycle(self):
        if self.mesh is None:
            return jax.jit(
                lambda ts, db, gl, it, rng, ds: self._cycle(ts, db, gl, it, rng, None, ds),
                donate_argnums=0,
            )

        mesh = self.mesh
        repl = P()
        data2 = P(None, "data")  # [n_critic, batch] sharded on batch
        data1 = P("data")

        def sharded(ts, d_batches, g_labels, iteration, rng, dataset):
            return self._cycle(ts, d_batches, g_labels, iteration, rng,
                               axis="data", dataset=dataset)

        mapped = shard_map(
            sharded,
            mesh=mesh,
            in_specs=(repl, data2, data1, repl, repl, repl),
            out_specs=(repl, repl),
            check_vma=False,
        )
        return jax.jit(mapped, donate_argnums=0)

    def step(self, ts: TrainState, d_batches: dict, g_labels: dict, iteration, rng):
        """``d_batches``: dict of arrays with leading dims [n_critic, B];
        ``g_labels``: {'random','biased'} int arrays [gen_bs_multiple*B].
        With a device-resident dataset, ``d_batches`` is {'index': [n_critic,
        B] int32} and the dataset rides along as a runtime argument."""
        return self._jitted_cycle(ts, d_batches, g_labels, jnp.asarray(iteration, jnp.int32),
                                  rng, self.device_dataset)

    # ----------------------------------------------- fused multi-cycle scan
    @functools.cached_property
    def _jitted_scan(self):
        """K whole cycles (each 1G+5D) as ONE ``lax.scan``ed XLA program
        over the device-resident dataset: one host dispatch per block
        instead of one per cycle (the MNIST stack's fused-epoch design,
        ported to the CIFAR hot loop).  Single-device path; the mesh path
        keeps per-cycle :meth:`step`."""

        def run(ts, payload, idx, g_random, g_biased):
            dataset = dict(payload)
            base_key = dataset.pop("__rng__")

            def body(carry, inp):
                ts = carry
                idx_row, gr, gb = inp
                # unique, resumable per-cycle stream keyed by step count;
                # iteration == ts.step (the app drives them in lockstep)
                rng = jax.random.fold_in(base_key, ts.step)
                it = jnp.asarray(ts.step, jnp.int32)
                ts, m = self._cycle(ts, {"index": idx_row}, {"random": gr, "biased": gb},
                                    it, rng, None, dataset)
                return ts, m

            return jax.lax.scan(body, ts, (idx, g_random, g_biased))

        return jax.jit(run, donate_argnums=0)

    def step_scan(self, ts: TrainState, idx, g_random, g_biased, rng: jax.Array):
        """Run ``idx.shape[0]`` fused cycles.  ``idx``: [K, n_critic, B]
        int32 dataset indices; ``g_random``/``g_biased``: [K, gen_mult*B]
        int32.  Requires a device-resident dataset.  Metrics come back
        stacked [K, ...]."""
        assert self.device_dataset is not None, "step_scan needs device_dataset"
        payload = dict(self.device_dataset)
        payload["__rng__"] = rng
        return self._jitted_scan(ts, payload, jnp.asarray(idx, jnp.int32),
                                 jnp.asarray(g_random, jnp.int32),
                                 jnp.asarray(g_biased, jnp.int32))

    # -------------------------------------------------------------- eval
    @functools.partial(jax.jit, static_argnums=0)
    def eval_disc_cost(self, ts: TrainState, batch: dict, rng: jax.Array) -> jax.Array:
        """Discriminator cost on a held-out batch without any updates — the
        dev-cost eval of ``gan_resnet.py:976-989``."""
        kq, kz = jax.random.split(rng)
        real = dequantize_chw_to_hwc(batch["images"], kq, self.cfg.img_size, self.cfg.img_dim)
        z = jax.random.normal(kz, (real.shape[0], self.cfg.z_dim), jnp.float32)
        sb = dict(batch, real_data=real)
        sb.pop("images", None)
        ctx = Ctx(params=ts.params, state=ts.state, rng=None, init=False,
                  train=True, update_sn=False, compute_dtype=self.compute_dtype)
        out = disc_loss(ctx, self.cfg, self.acfg, sb, z, self.confusion_actual)
        return out["disc_cost"]

    @functools.partial(jax.jit, static_argnums=0)
    def eval_disc_cost_scan(self, ts: TrainState, dataset: dict, idx,
                            rng: jax.Array) -> jax.Array:
        """Mean dev-set discriminator cost over ``idx`` [K, B] index batches
        of a device-resident split — ONE dispatch instead of K
        upload+sync round trips (the reference's dev-cost loop re-fed every
        batch through feed_dict, ``gan_resnet.py:976-989``)."""
        keys = jax.random.split(rng, idx.shape[0])

        def body(_, inp):
            idx_row, k = inp
            batch = {kk: jnp.take(v, idx_row, axis=0) for kk, v in dataset.items()}
            kq, kz = jax.random.split(k)
            real = dequantize_chw_to_hwc(batch["images"], kq, self.cfg.img_size,
                                         self.cfg.img_dim)
            z = jax.random.normal(kz, (real.shape[0], self.cfg.z_dim), jnp.float32)
            sb = dict(batch, real_data=real)
            sb.pop("images", None)
            ctx = Ctx(params=ts.params, state=ts.state, rng=None, init=False,
                      train=True, update_sn=False, compute_dtype=self.compute_dtype)
            return None, disc_loss(ctx, self.cfg, self.acfg, sb, z,
                                   self.confusion_actual)["disc_cost"]

        _, costs = jax.lax.scan(body, None, (jnp.asarray(idx, jnp.int32), keys))
        return jnp.mean(costs)

    # ------------------------------------------------------------ sample
    @functools.partial(jax.jit, static_argnums=0)
    def sample(self, ts: TrainState, z: jax.Array, labels: jax.Array) -> jax.Array:
        """Generator forward for eval/sampling.  Conditional batch-norm uses
        batch statistics even here — reference semantics
        (``normalization.py:47-58``)."""
        ctx = Ctx(params=ts.params, state=ts.state, rng=None, init=False,
                  train=True, update_sn=False, compute_dtype=self.compute_dtype)
        return generator(ctx, self.cfg, z, labels).astype(jnp.float32)
