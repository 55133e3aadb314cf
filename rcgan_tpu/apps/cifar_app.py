"""CIFAR-10 experiment orchestration (reference: ``cifar10/gan_resnet.py``
``main(_)``, lines 493-1035): run dirs, data, fused train cycles, periodic
inception / dev-cost / sample / gen-label-acc evals, checkpointing, and the
final (optionally permutation-corrected) label accuracy.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu import config as flagslib
from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu.data import cifar10 as cifar_data
from rcgan_tpu.data.confusion import one_coin_matrix
from rcgan_tpu.evals.classifier import cifar_classifier, generated_label_accuracy, train_pinned
from rcgan_tpu.evals.inception import inception_score
from rcgan_tpu.models.resnet_gan import ResnetGANConfig
from rcgan_tpu.parallel.mesh import make_mesh
from rcgan_tpu.train.checkpoint import Checkpointer
from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig
from rcgan_tpu.utils import run_dir as run_dir_lib
from rcgan_tpu.utils.images import save_cifar_samples, to_uint8_samples
from rcgan_tpu.utils.metrics import MetricLogger

log = logging.getLogger(__name__)


def build_configs(flags, n_devices: int):
    batch_size = flags.batch_size
    iters = flags.niters
    if flags.multi_gpu_multi_batch:  # gan_resnet.py:190-192
        batch_size *= n_devices
        iters //= n_devices
    cfg = ResnetGANConfig(
        z_dim=flags.z_dim,
        dim_g=flags.dim_g,
        dim_d=flags.dim_d,
        embedding_dim=flags.embedding_dim,
        algorithm=flags.algorithm,
        perm_type=flags.perm_type,
    )
    acfg = CifarAlgoConfig(
        algorithm=flags.algorithm,
        loss_type=flags.loss_type,
        soft_plus=flags.soft_plus,
        perm_classifier=flags.perm_classifier,
        perm_multiplier=flags.perm_multiplier,
        confuse_init=flags.confuse_init,
        confuse_init_diag=flags.confuse_init_diag,
    )
    tcfg = CifarTrainConfig(
        lr=flags.lr,
        n_critic=flags.n_critic,
        gen_bs_multiple=flags.gen_bs_multiple,
        decay=flags.decay,
        confuse_multiplier=flags.confuse_multiplier,
        confuse_lr_decay=flags.confuse_lr_decay,
        moment_dtype=flags.opt_moment_dtype,
    )
    return cfg, acfg, tcfg, batch_size, iters


def _cifar_images_hwc(split) -> np.ndarray:
    imgs = split.images.astype(np.float32)
    imgs = 2.0 * (imgs / 255.0 - 0.5)
    return imgs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def get_eval_classifier(train_split, dev_split, cache_dir: str, train_size: int = 20000):
    """Stand-in for the frozen ResNet-110 scorer, trained on clean labels to
    convergence and PINNED: its held-out clean accuracy is stored with the
    weights and re-verified on load (evals.classifier.train_pinned)."""
    cls = cifar_classifier()
    path = os.path.join(cache_dir, "cifar_eval_classifier.pkl")
    acc = train_pinned(
        cls, path,
        _cifar_images_hwc(train_split)[:train_size],
        train_split.labels_actual[:train_size],
        _cifar_images_hwc(dev_split), dev_split.labels_actual,
        epochs=5, rng=jax.random.key(321),
    )
    log.info("CIFAR eval classifier clean accuracy: %.4f (pin %s)",
             acc, cls.meta.get("clean_accuracy"))
    return cls


def stack_batches(split: cifar_data.CifarSplit, it, n_critic: int):
    """Pull n_critic epoch batches and stack to leading [n_critic, B]."""
    outs = []
    for _ in range(n_critic):
        try:
            outs.append(next(it))
        except StopIteration:
            return None
    imgs, labels, rand, biased, inv_w = (np.stack(x) for x in zip(*outs))
    return {
        "images": jnp.asarray(imgs.astype(np.int32)),
        "labels": jnp.asarray(labels.astype(np.int32)),
        "labels_random": jnp.asarray(rand.astype(np.int32)),
        "labels_biased": jnp.asarray(biased.astype(np.int32)),
        "labels_inv_weights": jnp.asarray(inv_w.astype(np.float32)),
    }


def infinite_batches(split, batch_size, n_critic):
    it = split.epoch(batch_size)
    while True:
        b = stack_batches(split, it, n_critic)
        if b is None:
            it = split.epoch(batch_size)
            continue
        yield b


def infinite_index_batches(split, batch_size, n_critic):
    """Index-only variant for device-resident datasets: epoch order matches
    ``CifarSplit.epoch`` (contiguous batches), but only int32 indices cross
    the host→device boundary.  Yields HOST arrays: the jitted step uploads
    them; the fused scan path stacks them host-side — yielding device arrays
    here would make every block assembly a device→host fetch."""
    n = (len(split) // batch_size) * batch_size
    pos = 0
    while True:
        idx = np.empty((n_critic, batch_size), np.int32)
        for j in range(n_critic):
            if pos + batch_size > n:
                pos = 0
            idx[j] = np.arange(pos, pos + batch_size, dtype=np.int32)
            pos += batch_size
        yield {"index": idx}


def device_dataset_of(split) -> dict:
    # images stay uint8 on the device (150 MB, not 600): the dequantize
    # step of the cycle widens them
    return {
        "images": split.images,
        "labels": split.labels.astype(np.int32),
        "labels_random": split.labels_random.astype(np.int32),
        "labels_biased": split.labels_biased.astype(np.int32),
        "labels_inv_weights": split.labels_inv_weights.astype(np.float32),
    }


def infinite_g_labels(split, batch_size, gen_bs_multiple):
    """labels_random/biased for the generator batch (gen_bs_multiple x B),
    mirroring ``inf_train_gen_G`` (``gan_resnet.py:869-882``)."""
    it = split.epoch(batch_size)
    while True:
        rs, bs_ = [], []
        for _ in range(gen_bs_multiple):
            try:
                _, _, r, b, _ = next(it)
            except StopIteration:
                it = split.epoch(batch_size)
                _, _, r, b, _ = next(it)
            rs.append(r)
            bs_.append(b)
        # host arrays (see infinite_index_batches): the step uploads, the
        # scan path stacks without device round trips
        yield {
            "random": np.concatenate(rs).astype(np.int32),
            "biased": np.concatenate(bs_).astype(np.int32),
        }


def main(argv=None):
    from rcgan_tpu.utils.compilation_cache import enable as enable_xla_cache

    enable_xla_cache()
    flags = flagslib.parse(flagslib.cifar_flags(), argv)
    # force=True: jax's import side effects configure the root logger first,
    # which would silently turn this into a no-op and lose the log file.
    logging.basicConfig(
        filename=flags.log_file, level=logging.DEBUG if flags.log_level == "debug" else logging.INFO,
        format="%(asctime)s %(levelname)-8s %(message)s", force=True,
    )

    # --ngpus is the reference's device-count flag (gan_resnet.py:53,183-192);
    # it sets the mesh size unless the rebuild-only --mesh_devices overrides.
    # The reference aliases its device list when ngpus exceeds the hardware
    # (gan_resnet.py:187-188) — the SPMD equivalent is capping at the mesh.
    n_devices = flags.mesh_devices or min(flags.ngpus, len(jax.devices()))
    if not flags.mesh_devices and flags.ngpus > len(jax.devices()):
        log.warning("--ngpus %d exceeds available devices (%d); using a %d-device mesh",
                    flags.ngpus, len(jax.devices()), n_devices)
    mesh = make_mesh(n_devices) if n_devices > 1 else None
    cfg, acfg, tcfg, batch_size, iters = build_configs(flags, n_devices)

    c_alpha = one_coin_matrix(flags.alpha, 10)
    if flags.expt_dir is not None:
        run_path = os.path.join(flags.parent_dir, flags.expt_dir)
    else:
        run_path = run_dir_lib.cifar_run_dir(flags.parent_dir, flags.algorithm, flags.alpha, flags.run)
    os.makedirs(run_path, exist_ok=True)
    run_dir_lib.record_setting(run_path, vars(flags))
    ckpt_dir = os.path.join(run_path, "checkpoint")
    log.info("alpha = %s; run dir %s; devices %d; batch %d; iters %d",
             flags.alpha, run_path, n_devices, batch_size, iters)

    train_split, dev_split = cifar_data.load(
        flags.data_dir, flags.alpha, allow_synthetic=flags.allow_synthetic,
        synthetic_train_size=flags.synthetic_train_size,
        synthetic_test_size=max(flags.batch_size, flags.synthetic_train_size // 5),
        noise_seed=flags.seed,  # replication knob; 0 = the archived stream
    )

    dtype = jnp.bfloat16 if flags.compute_dtype == "bfloat16" else jnp.float32
    device_dataset = device_dataset_of(train_split) if flags.device_data else None
    dev_device_dataset = None
    if flags.device_data:
        dev_device_dataset = {k: jnp.asarray(v)
                              for k, v in device_dataset_of(dev_split).items()}
    trainer = CifarTrainer(cfg, acfg, tcfg, c_alpha, mesh=mesh, compute_dtype=dtype,
                           device_dataset=device_dataset)
    ts = trainer.init(jax.random.key(flags.seed), batch_size)

    ckpt = Checkpointer(ckpt_dir)
    if flags.restore:
        restored = ckpt.restore(ts)
        if restored is not None:
            log.info("restored from step %s", int(restored.step))
            ts = restored

    metrics = MetricLogger()
    from rcgan_tpu.utils.summary import SummaryWriter

    tb = SummaryWriter(ckpt_dir)  # reference writes summaries to CHECKPOINT_DIR
    eval_cls = get_eval_classifier(train_split, dev_split, flags.parent_dir, flags.eval_train_size)

    # Inception scorer: real Inception-v3 (paper 11.31-anchor scale) when its
    # weights are dropped at <data_dir>/inception_v3.npz, else the compact
    # stand-in classifier (self-consistent, NOT on the paper scale).
    from rcgan_tpu.evals import inception_v3

    iv3_path = inception_v3.find_weights(flags.data_dir)
    if iv3_path is not None:
        iv3_params = inception_v3.load_weights(iv3_path)
        inception_v3.validate_weights(iv3_params)
        inception_logits_fn = inception_v3.make_logits_fn(iv3_params)
        log.info("inception scorer: Inception-v3 from %s (paper-scale; real-CIFAR "
                 "anchor ~11.31, inception_score_.py:82)", iv3_path)
    else:
        inception_logits_fn = lambda x: eval_cls.logits(eval_cls.params, x)
        log.info("inception scorer: compact stand-in (drop inception_v3.npz into "
                 "%s for paper-scale scores)", flags.data_dir)

    from rcgan_tpu.data.pipeline import Prefetcher

    if flags.device_data:
        d_iter = infinite_index_batches(train_split, batch_size, tcfg.n_critic)
    else:
        d_iter = Prefetcher(infinite_batches(train_split, batch_size, tcfg.n_critic), depth=2)
    g_iter = Prefetcher(infinite_g_labels(train_split, batch_size, tcfg.gen_bs_multiple), depth=2)

    fixed_noise = jnp.asarray(np.random.RandomState(0).normal(size=(100, cfg.z_dim)).astype(np.float32))
    fixed_labels = jnp.asarray(np.repeat(np.arange(10), 10).astype(np.int32))

    def make_samples(n, deterministic=True, seed=0):
        # dispatch every batch async, drain once at the end: one host sync
        # instead of n // 100
        outs, labels = [], []
        for i in range(n // 100):
            z = jax.random.normal(jax.random.fold_in(jax.random.key(seed), i), (100, cfg.z_dim))
            if deterministic:
                lab = fixed_labels
            else:
                lab = jax.random.randint(jax.random.fold_in(jax.random.key(seed + 1), i), (100,), 0, 10)
            outs.append(trainer.sample(ts, z, lab))
            labels.append(np.asarray(lab))
        return np.asarray(jnp.concatenate(outs)), np.concatenate(labels)

    from rcgan_tpu.train.failures import (
        PreemptionGuard,
        fault_injection_step,
        maybe_inject_fault,
    )

    if flags.profile_steps:
        # capture a device trace of warm steps (utils/profiling; view in TB)
        from rcgan_tpu.utils.profiling import trace

        ts, _ = trainer.step(ts, next(d_iter), next(g_iter), int(ts.step), jax.random.key(9))
        with trace(os.path.join(run_path, "profile")):
            for p_i in range(flags.profile_steps):
                ts, m = trainer.step(ts, next(d_iter), next(g_iter), int(ts.step) + p_i + 1,
                                     jax.random.key(10 + p_i))
            jax.block_until_ready(m["d_cost"])
        log.info("wrote profiler trace to %s", os.path.join(run_path, "profile"))

    start_iter = int(ts.step)
    inception_score_max = 0.0
    gen_label_acc_max = 0.0
    rng = jax.random.key(42 + flags.seed)
    pending = []
    guard = PreemptionGuard()
    t0 = time.time()

    def cadence_events(iteration, m):
        """Everything the reference hot loop does AT an iteration after its
        step (``gan_resnet.py:949-1007``): tb scalars, inception score,
        dev-cost + sample grids, gen-label accuracy, flush + checkpoint.
        Shared by the per-cycle path (called every iteration) and the fused
        scan path (called at block boundaries, which by construction land
        exactly on every cadence iteration)."""
        nonlocal inception_score_max, gen_label_acc_max, rng
        if iteration % 100 == 0:
            tb.scalar("D_wgan_cost", m["d_cost"], iteration)
            tb.scalar("G_wgan_cost", m["g_cost"], iteration)
            tb.scalar("lr", m["lr"], iteration)
            log.info("iter %d d_cost %.4f g_cost %.4f (%.3fs)", iteration,
                     float(m["d_cost"]), float(m["g_cost"]), time.time() - t0)
            if flags.algorithm == "rcgan-u":
                # learned-C drift vs the true C (gan_resnet.py:922-926)
                cm = np.asarray(jax.nn.softmax(
                    ts.groups["confusion"]["confusion_logits"]["logits"], axis=-1))
                drift = float(np.abs(cm - np.asarray(c_alpha)).max())
                diag = float(np.mean(np.diag(cm)))
                tb.scalar("confusion_drift", drift, iteration)
                log.info("iter %d learned-C: max|C-C*| %.4f mean diag %.4f (true %.2f)",
                         iteration, drift, diag, flags.alpha)

        if iteration % flags.inception_freq == flags.inception_freq - 1:
            log.info("starting inception score computation.")
            score, std = inception_score(
                sample_fn=lambda key, b: _sample_images_for_cls(trainer, ts, cfg, key, b),
                logits_fn=inception_logits_fn,
                n=50000, batch=500,
            )
            inception_score_max = max(inception_score_max, score)
            metrics.plot("inception_50k", score)
            metrics.plot("inception_50k_std", std)
            metrics.plot("inception_50k_max", inception_score_max)
            log.info("finished inception score computation.")

        if flags.sample_save_freq and iteration % flags.sample_save_freq == flags.sample_save_freq - 1:
            # periodic raw-sample dump (gan_resnet.py:969-973)
            samples, _ = make_samples(10000)
            np.save(os.path.join(run_path, f"_samples_{iteration}"), to_uint8_samples(samples))

        if iteration % flags.sample_freq == flags.sample_freq - 1:
            # dev cost over the held-out split (gan_resnet.py:976-989)
            rng, sub = jax.random.split(rng)
            if flags.device_data:
                # one scanned device program over the resident dev split
                # instead of an upload+sync round trip per dev batch
                n_dev = (len(dev_split) // batch_size) * batch_size
                dev_idx = np.arange(n_dev, dtype=np.int32).reshape(-1, batch_size)
                dev_cost = float(trainer.eval_disc_cost_scan(
                    ts, dev_device_dataset, dev_idx, sub))
            else:
                dev_costs = []
                for db in dev_split.epoch(batch_size):
                    images, labels, rand, biased, inv_w = db
                    batch = {
                        "images": jnp.asarray(images.astype(np.int32)),
                        "labels": jnp.asarray(labels.astype(np.int32)),
                        "labels_random": jnp.asarray(rand.astype(np.int32)),
                        "labels_biased": jnp.asarray(biased.astype(np.int32)),
                        "labels_inv_weights": jnp.asarray(inv_w.astype(np.float32)),
                    }
                    rng, sub = jax.random.split(rng)
                    dev_costs.append(float(trainer.eval_disc_cost(ts, batch, sub)))
                dev_cost = float(np.mean(dev_costs))
            metrics.plot("dev_cost", dev_cost)

            samples = np.asarray(trainer.sample(ts, fixed_noise, fixed_labels))
            save_cifar_samples(samples, os.path.join(run_path, f"samples_{iteration}.png"))

        if iteration % flags.generated_label_accuracy_freq == flags.generated_label_accuracy_freq - 1:
            samples, labels = make_samples(1000)
            acc = generated_label_accuracy(
                eval_cls, _to_cls_images(samples), labels
            )
            gen_label_acc_max = max(gen_label_acc_max, acc)
            metrics.plot("gen_label_acc", acc)
            metrics.plot("gen_label_acc_max", gen_label_acc_max)
            if flags.algorithm == "rcgan-u":
                # learned-C recovery error at the same cadence (round-4
                # item 6): permutation-corrected row-wise TV vs the true C
                from rcgan_tpu.evals.confusion_recovery import recovery_report

                cm = np.asarray(jax.nn.softmax(
                    ts.groups["confusion"]["confusion_logits"]["logits"], axis=-1))
                if flags.perm_gen_label_acc:
                    # permutation-corrected accuracy trajectory: the same
                    # argmax-binarized learned-C label remap the reference
                    # applies at the end of every rcgan-u run
                    # (gan_resnet.py:429-439,1022-1029), here logged at the
                    # gen-label-acc cadence alongside the raw column
                    acc_perm = generated_label_accuracy(
                        eval_cls, _to_cls_images(samples), labels, confusion_matrix=cm)
                    metrics.plot("gen_label_acc_perm", acc_perm)
                    log.info("iter %d gen-label-acc raw %.4f perm-corrected %.4f",
                             iteration, acc, acc_perm)
                rep = recovery_report(cm, np.asarray(c_alpha))
                metrics.plot("c_recovery_tv", rep["raw_tv"])
                metrics.plot("c_recovery_tv_perm", rep["perm_tv"])
                metrics.plot("c_mean_diag", rep["mean_diag"])
                log.info(
                    "iter %d learned-C recovery: TV=%.4f perm-TV=%.4f mean-diag=%.4f "
                    "perm=%s", iteration, rep["raw_tv"], rep["perm_tv"], rep["mean_diag"],
                    "identity" if rep["perm_is_identity"] else rep["perm"].tolist(),
                )

        if (iteration < 500) or (iteration % 1000 == 999):
            # reference cadence (gan_resnet.py:1007): flush + save every
            # early iteration.  Saves are async and early saves throttled
            # (--ckpt_early_every).
            metrics.dir_flush(run_path)
            if iteration >= 500 or iteration % max(1, flags.ckpt_early_every) == 0:
                ckpt.save(iteration, ts)

    def next_cadence_stop(i):
        """Smallest iteration >= i at which cadence_events must see the live
        train state: %100 tb/drift logs, the three eval cadences, the
        optional raw-sample dump, and the checkpoint schedule."""
        stops = [i + ((-i) % 100)]
        for freq in (flags.inception_freq, flags.sample_freq,
                     flags.generated_label_accuracy_freq):
            stops.append(i + ((freq - 1 - i) % freq))
        if flags.sample_save_freq:
            stops.append(i + ((flags.sample_save_freq - 1 - i) % flags.sample_save_freq))
        if i < 500:
            stops.append(i + ((-i) % max(1, flags.ckpt_early_every)))
        else:
            stops.append(i + ((999 - i) % 1000))
        stops.append(iters - 1)
        return min(s for s in stops if s >= i)

    use_scan = (flags.device_data and trainer.mesh is None
                and flags.scan_block and flags.scan_block > 1)
    iteration = start_iter
    while iteration < iters:
        if guard.should_stop():
            log.warning("preemption requested: checkpointing at iter %d and exiting", iteration)
            ckpt.save(iteration, ts)
            break
        maybe_inject_fault(iteration)
        t0 = time.time()
        if use_scan:
            # fused block: up to --scan_block cycles as ONE device program,
            # ending exactly on the next cadence iteration.  Fault injection
            # stays exact: a block never crosses the injected step.
            k = min(flags.scan_block, next_cadence_stop(iteration) - iteration + 1,
                    iters - iteration)
            fs = fault_injection_step()
            if fs is not None and iteration < fs < iteration + k:
                k = fs - iteration
            idxs = np.stack([next(d_iter)["index"] for _ in range(k)])
            gls = [next(g_iter) for _ in range(k)]
            g_random = np.stack([g["random"] for g in gls])
            g_biased = np.stack([g["biased"] for g in gls])
            rng, sub = jax.random.split(rng)
            ts, ms = trainer.step_scan(ts, idxs, g_random, g_biased, sub)
            # ONE stacked device->host fetch per block, not one per metric
            fetched = np.asarray(jnp.stack([ms["d_cost"], ms["g_cost"], ms["lr"]]))
            host = {"d_cost": fetched[0], "g_cost": fetched[1], "lr": fetched[2]}
            for j in range(k):
                metrics.plot_at("d_cost", float(host["d_cost"][j]), iteration + j)
                metrics.plot_at("g_cost", float(host["g_cost"][j]), iteration + j)
                metrics.tick()
            iteration += k
            m = {kk: v[-1] for kk, v in host.items()}
            cadence_events(iteration - 1, m)
        else:
            d_batches = next(d_iter)
            g_labels = next(g_iter)
            rng, sub = jax.random.split(rng)
            ts, m = trainer.step(ts, d_batches, g_labels, iteration, sub)

            # buffer loss scalars on device; one host fetch per block (a
            # per-step float() is a synchronizing round trip)
            pending.append((iteration, m["d_cost"], m["g_cost"]))
            flush_pending = len(pending) >= 50 or iteration == iters - 1 or (
                (iteration < 500) or (iteration % 1000 == 999)
            )
            if flush_pending:
                vals = np.asarray(jnp.stack([jnp.stack((d, g)) for _, d, g in pending]))
                for (it_i, _, _), (dv, gv) in zip(pending, vals):
                    metrics.plot_at("d_cost", float(dv), it_i)
                    metrics.plot_at("g_cost", float(gv), it_i)
                pending.clear()
            cadence_events(iteration, m)
            metrics.tick()
            iteration += 1

    # final gen-label accuracy, optionally permutation-corrected
    # (gan_resnet.py:1021-1035); when the correction applies we report BOTH
    # numbers so the archive shows raw vs perm-corrected side by side
    samples, labels = make_samples(1000)
    cm = None
    if flags.perm_gen_label_acc and flags.algorithm == "rcgan-u":
        cm = np.asarray(jax.nn.softmax(ts.params["confusion_logits"]["logits"], axis=-1))
    acc = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels, confusion_matrix=cm)
    if cm is not None:
        raw_acc = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels)
        metrics.plot("gen_label_acc_raw", raw_acc)
        log.info("final raw (uncorrected) generated label accuracy: %s", raw_acc)
    metrics.plot("gen_label_acc", acc)
    metrics.dir_flush(run_path)
    ckpt.close()  # finalize any in-flight async save
    tb.flush()
    tb.close()
    log.info("final generated label accuracy: %s", acc)
    return ts, acc


def _to_cls_images(samples_flat: np.ndarray) -> np.ndarray:
    """Generator output [-1,1] flat → classifier input [B,32,32,3]."""
    return to_uint8_samples(samples_flat).astype(np.float32) / 127.5 - 1.0


def _sample_images_for_cls(trainer, ts, cfg, key, batch):
    z = jax.random.normal(key, (batch, cfg.z_dim))
    labels = jax.random.randint(jax.random.fold_in(key, 1), (batch,), 0, 10)
    flat = trainer.sample(ts, z, labels)
    return flat.reshape(-1, 32, 32, 3)


if __name__ == "__main__":
    main()
