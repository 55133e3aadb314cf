"""MNIST experiment orchestration (reference: ``mnist/main.py:70-145`` +
``DCGAN.train`` ``mnist/model.py:249-491``): run-dir layout, training loop
with periodic sampling/checkpointing/eval, RCGAN+y epoch re-noising, and the
post-training label recovery — driven by the flag-parity CLI.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu import config as flagslib
from rcgan_tpu.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu.data import mnist as mnist_data
from rcgan_tpu.data.confusion import one_coin_matrix
from rcgan_tpu.evals.classifier import generated_label_accuracy, mnist_classifier, train_pinned
from rcgan_tpu.evals.recover import RecoverConfig, recover_labels
from rcgan_tpu.models.dcgan import DCGANConfig
from rcgan_tpu.train.checkpoint import Checkpointer
from rcgan_tpu.train.mnist_loop import MnistTrainer, MnistTrainConfig
from rcgan_tpu.utils import run_dir as run_dir_lib
from rcgan_tpu.utils.images import image_manifold_size, save_images
from rcgan_tpu.utils.metrics import MetricLogger

log = logging.getLogger(__name__)


def build_configs(flags):
    cfg = DCGANConfig(
        batch_size=flags.batch_size,
        z_dim=flags.z_dim,
        disc_type=flags.disc_type,
        spectral_norm=flags.spectral_norm,
        max_norm=flags.max_norm,
        concat_y=flags.concat_y,
        concat_y_layers=tuple(int(x) for x in flags.concat_y_layers),
    )
    acfg = MnistAlgoConfig(
        algorithm=flags.algorithm,
        estimate_confuse=flags.estimate_confuse,
        perm_regularizer=flags.perm_regularizer,
        loss_fn=flags.loss_fn,
        perm_multiplier=flags.perm_multiplier,
        confuse_multiplier=flags.confuse_multiplier,
        confuse_init=flags.confuse_init,
        confuse_init_diag=flags.confuse_init_diag,
    )
    tcfg = MnistTrainConfig(
        learning_rate=flags.learning_rate,
        beta1=flags.beta1,
        confuse_multiplier=flags.confuse_multiplier,
        perm_multiplier=flags.perm_multiplier,
    )
    return cfg, acfg, tcfg


def get_eval_classifier(data: mnist_data.MnistData, cache_dir: str, train_size: int = 60000):
    """Stand-in for the missing frozen ``mnist_dcnn`` classifier (SURVEY §2
    M10), trained to convergence on clean labels and PINNED: held-out clean
    accuracy is stored with the weights and re-verified on load."""
    cls = mnist_classifier()
    path = os.path.join(cache_dir, "mnist_eval_classifier.pkl")
    n_val = min(5000, len(data) // 10)
    n_train = min(train_size, len(data) - n_val)
    acc = train_pinned(
        cls, path,
        data.x[:n_train], data.y_actual[:n_train],
        data.x[len(data) - n_val:], data.y_actual[len(data) - n_val:],
        epochs=3, rng=jax.random.key(123),
    )
    log.info("MNIST eval classifier clean accuracy: %.4f (pin %s)",
             acc, cls.meta.get("clean_accuracy"))
    return cls


def batch_dict(data: mnist_data.MnistData, idx, y_real=None, y_fake=None):
    y_real = data.y_real if y_real is None else y_real
    y_fake = data.y_fake if y_fake is None else y_fake
    return {
        "images": jnp.asarray(data.x[idx]),
        "y_real": jnp.asarray(y_real[idx]),
        "y_gen": jnp.asarray(data.y_gen[idx]),
        "y_fake": jnp.asarray(y_fake[idx]),
        "y_real_weights": jnp.asarray(data.y_real_weights[idx]),
    }


def train(flags, trainer: MnistTrainer, ts, data: mnist_data.MnistData, ckpt: Checkpointer,
          sample_dir: str, eval_cls, metrics: MetricLogger):
    from rcgan_tpu.utils.summary import SummaryWriter

    tb = SummaryWriter(flags.logs_dir)
    bs = flags.batch_size
    n = min(len(data), int(flags.train_size) if np.isfinite(flags.train_size) else len(data))
    batch_idxs = n // bs
    rng = jax.random.key(flags.seed + 11)

    # fixed sample grid: 10 examples per class by generator label
    sample_z = np.random.RandomState(0).uniform(-1, 1, (bs, flags.z_dim)).astype(np.float32)
    per_class = [np.where(data.y_gen == i)[0][:10] for i in range(10)]
    sample_labels = data.y_gen[np.concatenate(per_class)[:bs]]
    sample_y = jnp.asarray(np.eye(10, dtype=np.float32)[sample_labels])

    from rcgan_tpu.train.failures import PreemptionGuard

    guard = PreemptionGuard()
    counter = 1
    pending = []
    static_dev, label_dev = None, None
    start = time.time()
    for epoch in range(flags.epoch):
        if guard.should_stop():
            log.warning("preemption requested: checkpointing at epoch %d and exiting", epoch)
            ckpt.save(counter, ts)
            break
        y_real_ep, y_fake_ep = data.y_real, data.y_fake
        if flags.add_noise:  # RCGAN+y annealed re-noising (mnist/model.py:293-333)
            rel_alpha = mnist_data.noise_schedule_alpha(
                epoch, flags.alpha, flags.noise_alpha, flags.noise_start, flags.noise_end
            )
            noise_c = one_coin_matrix(rel_alpha, 10)
            y_real_ep, y_fake_ep = mnist_data.renoise_labels(
                np.random.RandomState(epoch), data, noise_c
            )
            # Schedule-activity evidence (round-4 item 1): the relative coin
            # weight this epoch plus the measured survival fraction of the
            # re-noised labels — proves the annealing actually anneals
            # instead of sitting at the identity (rel_alpha == 1.0).
            survived = float(np.mean(y_real_ep == data.y_real))
            metrics.plot("noise_rel_alpha", rel_alpha)
            metrics.plot("noise_survival_frac", survived)
            log.info(
                "epoch %d re-noising: rel_alpha=%.4f, observed y_real survival=%.4f",
                epoch, rel_alpha, survived,
            )

        def log_line(idx, m_at):
            pr, pf = m_at["prob_real"], m_at["prob_fake"]
            log.info(
                "Epoch: [%2d] [%4d/%4d] time: %4.2f, d_loss: %.3f, g_loss: %.3f, "
                "d_real: %2d, %.3f, %.3f, d_fake: %2d, %.3f, %.3f",
                epoch, idx, batch_idxs, time.time() - start,
                float(m_at["d_loss"]), float(m_at["g_loss"]),
                int((pr >= 0.5).sum()), pr.min(), pr.max(),
                int((pf <= 0.5).sum()), pf.min(), pf.max(),
            )

        def tb_post(counter, m_at):  # tf.summary channel (mnist/model.py:268-272)
            for name in ("d_loss", "g_loss", "d_loss_real", "d_loss_fake",
                         "class_loss_real", "class_loss_fake"):
                tb.scalar(name, m_at[name], counter)
            tb.histogram("d", m_at["prob_real"], counter)
            tb.histogram("d_", m_at["prob_fake"], counter)

        def sample_and_ckpt(counter, idx):
            samples = np.asarray(trainer.sample(ts, jnp.asarray(sample_z), sample_y))
            save_images(samples, image_manifold_size(samples.shape[0]),
                        os.path.join(sample_dir, f"train_{epoch:02d}_{idx:04d}.png"))
            from rcgan_tpu.utils.images import merge

            tb.image("G", merge(samples, image_manifold_size(samples.shape[0]))[..., None],
                     counter)
            ckpt.save(counter, ts)

        use_scan = getattr(flags, "device_data", True) and trainer.mesh is None
        if use_scan:
            # Device-resident epoch (ROADMAP item 5): the full dataset lives
            # in device memory and K iterations run as ONE lax.scan'ed program — the
            # per-iteration Python dispatch + batch upload disappear.  The
            # big arrays upload ONCE (static_dev); only the labels change
            # across epochs (and only under --add_noise's re-noising).
            if static_dev is None:
                static_dev = {
                    "images": jnp.asarray(data.x[:n]),
                    "y_gen": jnp.asarray(data.y_gen[:n]),
                    "y_real_weights": jnp.asarray(data.y_real_weights[:n]),
                }
                label_dev = {
                    "y_real": jnp.asarray(y_real_ep[:n]),
                    "y_fake": jnp.asarray(y_fake_ep[:n]),
                }
            elif flags.add_noise:
                label_dev = {
                    "y_real": jnp.asarray(y_real_ep[:n]),
                    "y_fake": jnp.asarray(y_fake_ep[:n]),
                }
            dataset_dev = dict(static_dev, **label_dev)
            K = 50
            for b0 in range(0, batch_idxs, K):
                k = min(K, batch_idxs - b0)
                idxs = np.arange(b0 * bs, (b0 + k) * bs, dtype=np.int32).reshape(k, bs)
                rng, sub = jax.random.split(rng)
                ts, ms = trainer.step_scan(ts, dataset_dev, idxs, sub)
                # Batch the device->host fetch per block (per-metric
                # np.asarray = one host sync each): all [K]-shaped
                # scalar series in ONE stacked fetch; the few non-scalar
                # metrics (per-example probs, confusion) separately.
                scalars = sorted(kk for kk, v in ms.items() if v.ndim == 1)
                fetched = np.asarray(jnp.stack([ms[kk] for kk in scalars]))
                host = dict(zip(scalars, fetched))
                host.update({kk: np.asarray(v) for kk, v in ms.items() if kk not in host})
                for j in range(k):
                    idx = b0 + j
                    m_at = {kk: v[j] for kk, v in host.items()}
                    counter += 1
                    metrics.plot("d_loss", float(m_at["d_loss"]))
                    metrics.plot("g_loss", float(m_at["g_loss"]))
                    metrics.tick()
                    if (epoch < 1 and idx < 20) or idx % 350 == 0:
                        log_line(idx, m_at)
                    if counter % 50 == 1:
                        tb_post(counter, m_at)
                # cadence check at block end: with bs=100 (700 iters/epoch)
                # blocks align exactly with the reference's 700-step cadence
                if any((counter - j) % 700 == 1 for j in range(k)) and counter > 1:
                    sample_and_ckpt(counter, b0 + k - 1)
        else:
            for idx in range(batch_idxs):
                sl = slice(idx * bs, (idx + 1) * bs)
                batch = batch_dict(data, sl, y_real_ep, y_fake_ep)
                rng, sub = jax.random.split(rng)
                ts, m = trainer.step(ts, batch, sub)

                counter += 1
                if (epoch < 1 and idx < 20) or idx % 350 == 0:
                    log_line(idx, {kk: np.asarray(v) for kk, v in m.items()})
                # buffer loss scalars on device; one host fetch per block (a
                # per-step float() is a synchronizing round trip that would
                # throttle the loop like the reference's 5 extra sess.runs)
                pending.append((m["d_loss"], m["g_loss"]))
                if len(pending) >= 50 or idx == batch_idxs - 1:
                    vals = np.asarray(jnp.stack([jnp.stack(p) for p in pending]))
                    for dl, gl in vals:
                        metrics.plot("d_loss", float(dl))
                        metrics.plot("g_loss", float(gl))
                        metrics.tick()
                    pending.clear()
                if counter % 50 == 1:
                    tb_post(counter, {kk: np.asarray(v) for kk, v in m.items()})
                if counter % 700 == 1:
                    sample_and_ckpt(counter, idx)

        if (epoch + 1) % 5 == 0:  # gen-label-acc every 5 epochs (model.py:473-491)
            # dispatch all 100 sample batches async, concatenate on device,
            # fetch + classify once instead of a host sync per batch
            sample_y_np = np.asarray(sample_y)
            samps = []
            for i in range(100):
                z = np.random.RandomState(1000 + i).uniform(-1, 1, (bs, flags.z_dim)).astype(np.float32)
                samps.append(trainer.sample(ts, jnp.asarray(z), sample_y))
            s_all = np.asarray(jnp.concatenate(samps))
            labels_all = np.tile(np.argmax(sample_y_np, -1), 100)
            acc = float(generated_label_accuracy(eval_cls, s_all, labels_all))
            metrics.plot("gen_label_acc", acc)
            tb.scalar("gen_label_acc", acc, counter)
            log.info("######EPOCH=%d, mean generated label accuracy=%s", epoch, acc)
            if "confusion" in ts.groups:  # RCGAN-U learned-C recovery trajectory
                from rcgan_tpu.evals.confusion_recovery import recovery_report

                cm = np.asarray(jax.nn.softmax(
                    ts.groups["confusion"]["confusion_logits"]["logits"], axis=-1))
                rep = recovery_report(cm, data.confusion)
                metrics.plot("c_recovery_tv", rep["raw_tv"])
                metrics.plot("c_recovery_tv_perm", rep["perm_tv"])
                metrics.plot("c_mean_diag", rep["mean_diag"])
                tb.scalar("c_recovery_tv_perm", rep["perm_tv"], counter)
                log.info(
                    "######EPOCH=%d, learned-C recovery: TV=%.4f perm-TV=%.4f "
                    "mean-diag=%.4f perm=%s", epoch, rep["raw_tv"], rep["perm_tv"],
                    rep["mean_diag"],
                    "identity" if rep["perm_is_identity"] else rep["perm"].tolist(),
                )

    tb.flush()
    return ts


def main(argv=None):
    from rcgan_tpu.utils.compilation_cache import enable as enable_xla_cache

    enable_xla_cache()
    flags = flagslib.parse(flagslib.mnist_flags(), argv)
    flags.input_height = flags.output_height = 28
    flags.input_width = flags.input_width or 28
    flags.output_width = flags.output_width or 28
    # The reference force-overrides these after parsing (mnist/main.py:84,107):
    # sample_dir is always <run>/samples and dataset is always 'mnist'.  Keep
    # the same semantics but say so instead of silently ignoring the value.
    if flags.dataset != "mnist":
        raise SystemExit(
            f"--dataset {flags.dataset!r}: the MNIST CLI supports only 'mnist' "
            "(the reference hard-codes FLAGS.dataset='mnist', mnist/main.py:107)")
    if flags.sample_dir not in ("samples/", "samples"):
        log.warning("--sample_dir %r is overridden to <run>/samples, matching "
                    "the reference (mnist/main.py:84)", flags.sample_dir)
    # crop selects output vs input dims in the reference (mnist/model.py:112);
    # both are forced to 28 above, so either setting yields the same pipeline.

    prefix = "" if flags.dir_prefix is None else flags.dir_prefix + "_"
    if flags.checkpoint is None:
        run_path = run_dir_lib.mnist_run_dir(
            flags.checkpoint_dir, prefix, flags.algorithm, flags.alpha, flags.disc_type
        )
    else:
        run_path = os.path.join(flags.checkpoint_dir, flags.checkpoint)
    sample_dir = os.path.join(run_path, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    run_dir_lib.record_setting(run_path, vars(flags), script_file=flags.script_file)
    # force=True: jax's import already configured the root logger
    logging.basicConfig(level=logging.INFO, force=True)
    if flags.logs_at_ckpt:
        flags.logs_dir = run_path
    log.info("run dir: %s", run_path)

    data = mnist_data.load_mnist(
        flags.data_dir, flags.alpha, flags.confusion_class_depend, flags.real_match,
        seed=flags.seed, allow_synthetic=flags.allow_synthetic,
    )
    log.info("C=\n%s\nC_inv=\n%s", data.confusion, data.confusion_inv)

    cfg, acfg, tcfg = build_configs(flags)
    dtype = jnp.bfloat16 if flags.compute_dtype == "bfloat16" else jnp.float32
    n_mesh = flags.mesh_devices or len(jax.devices())
    mesh = None
    if n_mesh > 1:
        from rcgan_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_mesh)
    trainer = MnistTrainer(cfg, acfg, tcfg, data.confusion, mesh=mesh, compute_dtype=dtype)
    ts = trainer.init(jax.random.key(flags.seed), batch_dict(data, slice(0, flags.batch_size)))
    from rcgan_tpu.utils.visualize import show_all_variables

    show_all_variables(ts.params)  # parameter census (mnist/utils.py:21-23)

    ckpt = Checkpointer(os.path.join(run_path, "ckpt"))
    metrics = MetricLogger()
    eval_cls = get_eval_classifier(data, flags.checkpoint_dir, flags.eval_train_size)

    restored = ckpt.restore(ts)
    if flags.train or restored is None:
        if restored is not None:
            ts = restored
        ts = train(flags, trainer, ts, data, ckpt, sample_dir, eval_cls, metrics)
        ckpt.save(int(ts.step), ts, wait=True)
    else:
        ts = restored
    metrics.dir_flush(run_path)

    if flags.visualize:  # z-space walks (mnist/utils.py visualize)
        from rcgan_tpu.utils.visualize import visualize

        visualize(
            lambda z, y: np.asarray(trainer.sample(ts, jnp.asarray(z), jnp.asarray(y))),
            flags.z_dim, 10, flags.batch_size, os.path.join(run_path, "visualize"), option=2,
        )

    # ---- label recovery always runs after training (mnist/main.py:142)
    rcfg = RecoverConfig(
        batch_size=flags.recover_batch_size,
        epochs=flags.recover_epoch,
        learning_rate=flags.recover_learning_rate,
        z_dim=flags.z_dim,
    )
    rs = np.random.RandomState(0)
    pick = rs.randint(len(data), size=rcfg.batch_size)
    sampler = lambda z, y: trainer.sample(ts, z, y)
    _, rec_metrics = recover_labels(
        sampler,
        jnp.asarray(data.x[pick]),
        jnp.asarray(data.y_actual[pick]),
        rcfg,
        jax.random.key(7),
    )
    log.info("label recovery accuracy: %s", rec_metrics["accuracy"])
    with open(os.path.join(run_path, "recovery.txt"), "w") as f:
        f.write(f"accuracy {rec_metrics['accuracy']}\n")
    from rcgan_tpu.evals.recover import render_wrong_image_diagnostics

    render_wrong_image_diagnostics(
        lambda z, y: np.asarray(trainer.sample(ts, jnp.asarray(z), jnp.asarray(y))),
        data.x[pick], data.y_actual[pick],
        rec_metrics["y_recover"], rec_metrics["z_recover"],
        os.path.join(run_path, "recover_wrong_images.png"),
    )
    return ts, rec_metrics


if __name__ == "__main__":
    main()
