"""Chip smoke test: the quickest proof that the system runs on the GPU.

    python chip_smoke.py              # one card: every phase below but 6
    python chip_smoke.py --chips 4    # four cards: phase 6 only

Phases, in order, in one process that holds the card(s):

1. Device: the platform is ``gpu``; print the card's name and power limit,
   the JAX version, ``XLA_FLAGS`` and the compile-cache directory.
2. Op checks at real widths against float64 NumPy oracles on the host: the
   3x3 conv, conditional batch-norm, spectral norm (with its gradient through
   the power iteration), the all-label projection logits and the dequantize
   distribution.  Each runs in float32 under ``highest`` matmul precision
   with a tight tolerance, and in bf16 at default precision with a looser
   one; each tolerance is printed with its reason.
3. Full-size forward (``__graft_entry__.entry``): card float32 against the
   host CPU float32, and card bf16 against card float32.
4. One full-size rcgan-u training cycle with the permutation classifier:
   card against host CPU, both float32 at highest precision.  The host's
   cycle takes minutes; it runs in a thread from the start, and its
   comparison prints after phase 5.
5. The apps: ``cifar_app.main`` at its default width (dim 128, batch 64,
   bf16, device-resident data, scan path) and one short MNIST epoch.
6. (``--chips 4``) the multi-card path: ``cifar_app`` with ``--ngpus 4``,
   the 4-way sharded cycle against the single-card cycle at full width,
   and the GSPMD dp x tp cycle on a 2x2 mesh (at dim 16).

Any failed check raises, so the script exits non-zero.  On success the last
line of standard output is one JSON object naming the device.  Without a
GPU, or outside a checkout of this repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
from contextlib import nullcontext
import os
import shutil
import sys
import threading
import time

# The host CPU computes the float32 references beside the card.
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "runs", "chip_smoke")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="1: phases 1-5 on one card; 4: the multi-card phase only")
    return p.parse_args(argv)


def last_line(device: dict) -> str:
    """The result line: ``{"ok": true, "device": {platform, kind, count}}``."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"]}})


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, tol: float, reason: str) -> None:
    """Print one comparison with its tolerance and reason; raise on failure."""
    ok = bool(err <= tol)
    log(f"  [{'ok' if ok else 'FAIL'}] {name}: error {err:.3e} <= tol {tol:.0e} ({reason})")
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:.0e}")


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|, in float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# ------------------------------------------------------------ oracles


def np_conv3x3(x, w):
    """SAME 3x3 stride-1 NHWC conv in float64."""
    x = np.pad(np.asarray(x, np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(x, (3, 3), axis=(1, 2))  # [B,H,W,C,3,3]
    return np.einsum("bhwcij,ijco->bhwo", win, np.asarray(w, np.float64), optimize=True)


def np_cond_bn(x, labels, scale_m, offset_m, eps=1e-5):
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=(0, 1, 2), keepdims=True)
    var = ((x - mean) ** 2).mean(axis=(0, 1, 2), keepdims=True)
    scale = np.asarray(scale_m, np.float64)[labels][:, None, None, :]
    offset = np.asarray(offset_m, np.float64)[labels][:, None, None, :]
    return (x - mean) / np.sqrt(var + eps) * scale + offset


def np_sn(w, u, eps=1e-12):
    """One power-iteration step and ``W / sigma`` in float64 (ops/sn.py)."""
    w = np.asarray(w, np.float64).reshape(-1, np.shape(w)[-1])
    u = np.asarray(u, np.float64)
    v = u @ w.T
    v = v / (np.sqrt(np.sum(v**2)) + eps)
    u2 = v @ w
    u2 = u2 / (np.sqrt(np.sum(u2**2)) + eps)
    sigma = (v @ w @ u2.T)[0, 0]
    return w / sigma, sigma


# ------------------------------------------------------------- phases


def phase_device(args):
    import jax

    from rcgan_tpu.utils.compilation_cache import enable
    from rcgan_tpu.utils.profiling import device_info, gpu_name_and_power_limit

    device = device_info()
    if device["platform"] != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {device}")
    if device["count"] < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} cards; JAX found {device}")
    log("== phase 1: device")
    log(gpu_name_and_power_limit())
    log(f"  jax {jax.__version__}; devices {device}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {enable()}")
    return device


def phase_ops():
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.core.module import Ctx
    from rcgan_tpu.core.rng import example_keys
    from rcgan_tpu.data.cifar10 import dequantize_chw_to_hwc_keys
    from rcgan_tpu.models import resnet_gan
    from rcgan_tpu.ops.conv import conv2d_lib
    from rcgan_tpu.ops.norm import cond_batchnorm
    from rcgan_tpu.ops.sn import spectral_normed_weight

    log("== phase 2: op checks against float64 NumPy oracles")
    rs = np.random.RandomState(0)
    hi = jax.default_matmul_precision("highest")
    modes = (("f32/highest", jnp.float32, hi), ("bf16/default", jnp.bfloat16, nullcontext()))

    def run(fn, *a, ctx_manager):
        with ctx_manager:
            return jax.jit(fn)(*a)

    # -- 3x3 conv, 128 -> 128 channels, as the ResNet blocks call it
    w = (rs.randn(3, 3, 128, 128) / np.sqrt(9 * 128)).astype(np.float32)
    for batch in (64, 128):
        for size in (32, 16, 8):
            x = rs.randn(batch, size, size, 128).astype(np.float32)
            ref = np_conv3x3(x[:4], w)  # examples are independent: check 4 of them
            for tag, dtype, prec in modes:
                def f(x, w, dtype=dtype):
                    ctx = Ctx(params={"c": {"Filters": w}}, compute_dtype=dtype)
                    return conv2d_lib(ctx, x, 128, 128, 3, 1, "c", biases=False)
                out = run(f, x, w, ctx_manager=prec)
                if dtype == jnp.float32:
                    check(f"conv3x3 b{batch} {size}x{size} {tag}", rel_err(out[:4], ref), 1e-5,
                          "float32 sums of 1152 products in another order")
                else:
                    check(f"conv3x3 b{batch} {size}x{size} {tag}", rel_err(out[:4], ref), 2e-2,
                          "bf16 operands and output keep 8 mantissa bits")

    # -- conditional batch-norm at the generator's widest map
    x = (2.0 * rs.randn(128, 32, 32, 128) + 0.5).astype(np.float32)
    labels = rs.randint(0, 10, 128).astype(np.int32)
    scale_m = (1.0 + 0.1 * rs.randn(10, 128)).astype(np.float32)
    offset_m = (0.1 * rs.randn(10, 128)).astype(np.float32)
    ref = np_cond_bn(x, labels, scale_m, offset_m)
    for tag, dtype, prec in modes:
        def f(x, labels, s, o):
            ctx = Ctx(params={"bn": {"scale": s, "offset": o}})
            return cond_batchnorm(ctx, x, labels, 10, "bn")
        out = run(f, x.astype(dtype), labels, scale_m, offset_m, ctx_manager=prec)
        if dtype == jnp.float32:
            check(f"cond_bn [128,32,32,128] {tag}", rel_err(out, ref), 1e-5,
                  "float32 moments over 131072 values per channel")
        else:
            check(f"cond_bn [128,32,32,128] {tag}", rel_err(out, ref), 1e-2,
                  "bf16 input and output: 2^-9 relative rounding each")

    # -- spectral norm of the [1152, 128] conv weights, and its gradient
    w = (0.05 * rs.randn(3, 3, 128, 128)).astype(np.float32)
    u = rs.randn(1, 128).astype(np.float32)
    g_out = rs.randn(1152, 128)
    wbar_ref, sigma_ref = np_sn(w, u)

    def sn_loss_np(wm):
        wb, _ = np_sn(wm.reshape(w.shape), u)
        return float(np.sum(np.tanh(wb) * g_out))

    for tag, dtype, prec in modes:
        def f(w, u):
            ctx = Ctx(params={}, state={"sn": {"u": u}})
            wb, sigma = spectral_normed_weight(ctx, "sn", w, with_sigma=True)
            return wb, sigma
        wb, sigma = run(f, w.astype(dtype), u, ctx_manager=prec)
        tol, why = ((1e-5, "float32 matvecs at HIGHEST precision") if dtype == jnp.float32
                    else (1e-2, "W_bar stored in bf16"))
        check(f"sn W_bar [1152,128] {tag}", rel_err(wb.reshape(1152, 128), wbar_ref), tol, why)
        if dtype == jnp.float32:
            check(f"sn sigma {tag}", abs(float(sigma) - sigma_ref) / sigma_ref, 1e-5,
                  "sigma's matvecs ask for HIGHEST precision")
        else:
            sig_w = np_sn(np.asarray(w.astype(jnp.bfloat16), np.float32), u)[1]
            check(f"sn sigma {tag}", abs(float(sigma) - sig_w) / sig_w, 1e-5,
                  "sigma is float32 at HIGHEST precision even for bf16 weights: no TF32")

    def sn_loss(wm):
        ctx = Ctx(params={}, state={"sn": {"u": jnp.asarray(u)}})
        wb = spectral_normed_weight(ctx, "sn", wm.reshape(w.shape))
        return jnp.sum(jnp.tanh(wb.reshape(1152, 128)) * jnp.asarray(g_out, jnp.float32))

    with hi:
        grad = np.asarray(jax.jit(jax.grad(sn_loss))(jnp.asarray(w.reshape(1152, 128))), np.float64)
    wm = w.reshape(1152, 128).astype(np.float64)
    h = 1e-6
    for i in range(3):  # directional derivatives by central differences in float64
        d = np.random.RandomState(10 + i).randn(*wm.shape)
        fd = (sn_loss_np(wm + h * d) - sn_loss_np(wm - h * d)) / (2 * h)
        check(f"sn gradient through the power iteration, direction {i} f32/highest",
              abs(float(np.sum(grad * d)) - fd) / abs(fd), 1e-4,
              "float32 gradient against float64 central differences")

    # -- all-label projection logits [64,128] x [10,128] through the model code
    cfg = resnet_gan.ResnetGANConfig()
    init = Ctx(rng=jax.random.key(0), init=True)
    feat = rs.randn(64, 128).astype(np.float32)
    wgan = rs.randn(64).astype(np.float32)
    resnet_gan.all_label_logits(init, cfg, jnp.asarray(feat), jnp.asarray(wgan))
    params, state = init.params, init.state
    table = np.asarray(params["D.Embedding.Label"]["embedding_map"], np.float64)
    wproj, _ = np_sn(params["D.Embedding_y"]["W"], state["D.Embedding_y"]["u"])
    proj = table @ wproj + np.asarray(params["D.Embedding_y"]["b"], np.float64)
    ref = wgan[:, None].astype(np.float64) + feat.astype(np.float64) @ proj.T
    for tag, dtype, prec in modes:
        def f(params, state, feat, wgan, dtype=dtype):
            ctx = Ctx(params=params, state=state, update_sn=False, compute_dtype=dtype)
            return resnet_gan.all_label_logits(ctx, cfg, feat, wgan)
        out = run(f, params, state, feat.astype(dtype), wgan.astype(dtype), ctx_manager=prec)
        tol, why = ((1e-5, "float32 products over 300 and 128 terms") if dtype == jnp.float32
                    else (2e-2, "bf16 operands through two matmuls"))
        check(f"all_label_logits [64,128]x[10,128] {tag}", rel_err(out, ref), tol, why)

    # -- dequantize [64, 3072]: range, channel order and noise distribution
    images = rs.randint(0, 256, (64, 3072)).astype(np.int32)
    keys = example_keys(jax.random.key(3), 64, None)
    out = np.asarray(jax.jit(dequantize_chw_to_hwc_keys)(images, keys), np.float64)
    base = (2.0 * (images / 256.0 - 0.5)).reshape(64, 3, 32, 32).transpose(0, 2, 3, 1)
    noise = out - base.reshape(64, 3072)
    check("dequantize noise >= 0 (channel order CHW -> HWC)", max(0.0, -noise.min()), 0.0,
          "noise is U[0, 1/128); a wrong channel order shows as O(1) negative values")
    check("dequantize noise < 1/128", max(0.0, noise.max() - 1 / 128), 1e-7,
          "float32 rounding of x + u")
    se = (1 / 128) / np.sqrt(12) / np.sqrt(noise.size)
    check("dequantize noise mean", abs(noise.mean() - 0.5 / 128) / se, 6.0,
          "in standard errors of the mean of 196608 uniforms")
    hist = np.histogram(noise, bins=16, range=(0, 1 / 128))[0] / noise.size
    check("dequantize noise histogram", float(np.max(np.abs(hist * 16 - 1))), 0.05,
          "16 equal bins of 12288 expected counts each, ~1% sampling noise")


def phase_forward():
    import jax
    import jax.numpy as jnp

    import __graft_entry__

    log("== phase 3: full-size forward (G + D projection logits, batch 64)")
    cpu = jax.devices("cpu")[0]
    fwd32, args = __graft_entry__.entry(jnp.float32)
    fwd16, _ = __graft_entry__.entry(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        card32 = np.asarray(jax.jit(fwd32)(*args))
        host32 = np.asarray(jax.jit(fwd32)(*jax.device_put(args, cpu)))
    card16 = np.asarray(jax.jit(fwd16)(*args), np.float32)
    assert card32.shape == (64,) and np.isfinite(card32).all() and np.isfinite(card16).all()
    check("forward card f32/highest vs host CPU f32", rel_err(card32, host32), 1e-3,
          "two float32 programs summing in different orders through 20 conv layers")
    check("forward card bf16 vs card f32", rel_err(card16, card32), 1e-1,
          "bf16 activations through 20 conv layers and 4 batch norms")


def _cycle_inputs(trainer, batch, seed):
    rs = np.random.RandomState(seed)
    nc, gb = trainer.tcfg.n_critic, trainer.tcfg.gen_bs_multiple * batch
    d_batches = {
        "images": rs.randint(0, 256, (nc, batch, 3072)).astype(np.int32),
        "labels": rs.randint(0, 10, (nc, batch)).astype(np.int32),
        "labels_random": rs.randint(0, 10, (nc, batch)).astype(np.int32),
        "labels_biased": rs.randint(0, 10, (nc, batch)).astype(np.int32),
        "labels_inv_weights": rs.rand(nc, batch, 10).astype(np.float32),
    }
    g_labels = {"random": rs.randint(0, 10, gb).astype(np.int32),
                "biased": rs.randint(0, 10, gb).astype(np.int32)}
    return d_batches, g_labels


def compare_cycles(name, ts_a, m_a, ts_b, m_b, init_groups):
    """Costs and parameter changes of one cycle run two ways.

    Costs use the tolerances of the sharded-against-single-device test
    (tests/test_parallel.py).  Parameter changes are compared per group
    (generator, discriminator, confusion) in the L2 norm: under another
    summation order a ReLU input within rounding of zero switches sides,
    an Adam update whose gradient sits at zero flips sign, and later
    critic steps see those changes, so some elements differ by O(1) of
    their update.  The generator's conv biases ahead of a batch norm have
    a gradient of exactly zero, so Adam gives those ~2,300 elements
    full-size updates of random sign: they alone put about 4% between two
    runs of the generator group (measured card against host CPU).  A
    wiring error moves the whole group.  The share of elements outside
    test_parallel's per-element tolerance, and the leaves that differ
    most, are printed beside it."""
    for k in ("d_cost", "g_cost"):
        a, b = float(m_a[k]), float(m_b[k])
        assert np.isfinite(a) and np.isfinite(b), (k, a, b)
        check(f"{name} {k}", abs(a - b) - 1e-4 * abs(b), 1e-5,
              "|a-b| - 1e-4|b| <= 1e-5: float32 reduction order")
    import jax

    leaves, outside, total, groups = [], 0, 0, {}
    for group, p0 in init_groups.items():
        num = den = 0.0
        paths = jax.tree_util.tree_flatten_with_path(ts_a.groups[group])[0]
        for (path, a), b, p in zip(paths, jax.tree_util.tree_leaves(ts_b.groups[group]),
                                   jax.tree_util.tree_leaves(p0)):
            d_a, d_b = np.asarray(a, np.float64) - p, np.asarray(b, np.float64) - p
            diff = float(np.sum((d_a - d_b) ** 2))
            num, den = num + diff, den + float(np.sum(d_b ** 2))
            leaves.append((np.sqrt(diff / max(float(np.sum(d_b ** 2)), 1e-30)), group,
                           jax.tree_util.keystr(path), d_b.size))
            scale = max(float(np.max(np.abs(d_b))), 1e-8)
            outside += int(np.sum(np.abs(d_a - d_b) > 2e-3 * scale + 1e-4 * np.abs(d_b)))
            total += d_b.size
        groups[group] = np.sqrt(num / max(den, 1e-30))
    log(f"  {name}: {outside} of {total} parameters ({outside / total:.2e}) outside "
        "test_parallel's per-element tolerance; leaves differing most (L2): " + ", ".join(
            f"{g}{k} [{n}] {r:.2e}" for r, g, k, n in sorted(leaves, reverse=True)[:4]))
    for group, err in groups.items():
        check(f"{name} {group} parameter changes", err, 1e-1,
              "|change_a - change_b| / |change_b| in L2 over the group")


class HostCycle(threading.Thread):
    """The host CPU's float32 reference for phase 4, one full-size rcgan-u
    cycle.  It takes minutes, so it runs in a thread from the start while
    the card works through phases 2 to 5; ``result()`` joins it and
    re-raises what it raised."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        import bench

        super().__init__(daemon=True)
        self.trainer, ts, _, _ = bench.cifar_setup(algorithm="rcgan-u", compute_dtype=jnp.float32)
        self.d_batches, self.g_labels = _cycle_inputs(self.trainer, 64, seed=1)
        self.initial = jax.tree_util.tree_map(np.asarray, ts)
        self.card_ts = ts
        self.rng = jax.random.key(5)
        self._out, self._error = None, None

    def run(self):
        import jax

        try:
            cpu = jax.devices("cpu")[0]
            t0 = time.perf_counter()
            with jax.default_matmul_precision("highest"):
                ts, m = self.trainer.step(
                    jax.device_put(self.initial, cpu), jax.device_put(self.d_batches, cpu),
                    jax.device_put(self.g_labels, cpu), 1, jax.device_put(self.rng, cpu))
                jax.block_until_ready(m)
            self._out = (ts, m, time.perf_counter() - t0)
        except Exception as e:  # re-raised on the main thread by result()
            self._error = e

    def result(self):
        self.join()
        if self._error is not None:
            raise self._error
        return self._out


def phase_cycle(host: HostCycle):
    """Run the card's cycle; return the comparison with the host CPU's,
    which main() calls once phase 5 has run beside the host thread."""
    import jax

    log("== phase 4: one full-size rcgan-u cycle, card vs host CPU (float32, highest)")
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ts_card, m_card = host.trainer.step(host.card_ts, host.d_batches, host.g_labels, 1,
                                            host.rng)
        jax.block_until_ready(m_card)
    log(f"  card cycle {time.perf_counter() - t0:.1f} s (with compilation); the host CPU's "
        "is compared after phase 5")

    def compare():
        ts_host, m_host, t_host = host.result()
        log(f"== phase 4, continued: host CPU cycle {t_host:.1f} s (with compilation)")
        compare_cycles("cycle card vs host", ts_card, m_card, ts_host, m_host,
                       dict(host.initial.groups))

    return compare


def _metric_values(run_path, name):
    for line in open(os.path.join(run_path, "metrics.jsonl")):
        row = json.loads(line)
        if row["name"] == name:
            return np.asarray(row["values"])
    raise AssertionError(f"{name} missing from {run_path}/metrics.jsonl")


def phase_apps():
    from rcgan_tpu.apps import cifar_app, mnist_app

    log("== phase 5: apps")
    root = os.path.join(RUN_DIR, "apps")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ts, acc = cifar_app.main([
        "--algorithm", "rcgan-u", "--alpha", "0.6", "--perm_classifier",
        "--niters", "2", "--expt_dir", "run", "--parent_dir", os.path.join(root, "cifar"),
        "--log_file", os.path.join(root, "cifar.log"), "--data_dir", os.path.join(root, "none"),
        "--synthetic_train_size", "10000", "--eval_train_size", "5000",
    ])
    run = os.path.join(root, "cifar", "run")
    assert int(ts.step) == 2 and 0.0 <= acc <= 1.0, (int(ts.step), acc)
    assert os.path.exists(os.path.join(run, "checkpoint", "0", "state.npz")), os.listdir(run)
    for name in ("d_cost", "g_cost"):
        vals = _metric_values(run, name)
        assert len(vals) == 2 and np.isfinite(vals).all(), (name, vals)
    log(f"  cifar_app rcgan-u dim 128 batch 64 bf16 scan path: 2 cycles, checkpoint 0, "
        f"final gen-label-acc {acc:.4f} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ck = os.path.join(root, "mnist")
    ts, rec = mnist_app.main([
        "--algorithm", "rcgan", "--alpha", "0.3", "--disc_type", "projection",
        "--noestimate_confuse", "--noaux_classifier", "--noadd_noise", "--noconcat_y",
        "--spectral_norm", "--max_norm", "--train", "--epoch", "1", "--train_size", "700",
        "--batch_size", "100", "--recover_epoch", "30", "--checkpoint_dir", ck,
        "--data_dir", os.path.join(root, "none"), "--compute_dtype", "float32",
    ])
    runs = [d for d in os.listdir(ck) if d.startswith("rcgan_0.3")]
    assert len(runs) == 1, os.listdir(ck)
    run = os.path.join(ck, runs[0])
    for f in ("ckpt", "samples", "command.txt", "config.json", "recovery.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(run, f)), (f, os.listdir(run))
    for name in ("d_loss", "g_loss"):
        vals = _metric_values(run, name)
        assert len(vals) == 7 and np.isfinite(vals).all(), (name, vals)
    assert int(ts.step) == 7 and 0.0 <= rec["accuracy"] <= 1.0
    log(f"  mnist_app rcgan projection: 1 epoch of 7 steps, recovery accuracy "
        f"{rec['accuracy']:.4f} ({time.perf_counter() - t0:.1f} s)")


def phase_multichip():
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu.apps import cifar_app
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu.parallel.gspmd import (
        apply_shardings, gspmd_cycle, make_dp_tp_mesh, train_state_shardings)
    from rcgan_tpu.parallel.mesh import make_mesh
    from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

    log("== phase 6: four cards")
    root = os.path.join(RUN_DIR, "multichip")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ts, acc = cifar_app.main([
        "--algorithm", "rcgan-u", "--alpha", "0.6", "--perm_classifier", "--ngpus", "4",
        "--niters", "8", "--expt_dir", "run", "--parent_dir", root,
        "--log_file", os.path.join(root, "cifar.log"), "--data_dir", os.path.join(root, "none"),
        "--synthetic_train_size", "5120", "--eval_train_size", "2000",
    ])
    assert 0.0 <= acc <= 1.0
    assert int(ts.step) == 2, int(ts.step)  # --niters 8 over 4 devices
    log(f"  cifar_app --ngpus 4: global batch 256, {int(ts.step)} cycles, final gen-label-acc "
        f"{acc:.4f} ({time.perf_counter() - t0:.1f} s)")

    # 4-way sharded cycle against the single-card cycle, full width, global batch 64
    cfg = ResnetGANConfig(algorithm="rcgan", normalization_g=False)
    acfg = CifarAlgoConfig(algorithm="rcgan")
    tcfg = CifarTrainConfig(n_critic=5)
    c = one_coin_matrix(0.6, 10)
    tr_sh = CifarTrainer(cfg, acfg, tcfg, c, mesh=make_mesh(4))
    tr_1 = CifarTrainer(cfg, acfg, tcfg, c, mesh=None)
    ts_sh, ts_1 = tr_sh.init(jax.random.key(0), 64), tr_1.init(jax.random.key(0), 64)
    init_groups = {g: jax.tree_util.tree_map(np.asarray, ts_1.groups[g]) for g in ts_1.groups}
    d_batches, g_labels = _cycle_inputs(tr_1, 64, seed=2)
    with jax.default_matmul_precision("highest"):
        ts_sh, m_sh = tr_sh.step(ts_sh, d_batches, g_labels, 1, jax.random.key(3))
        ts_1, m_1 = tr_1.step(ts_1, d_batches, g_labels, 1, jax.random.key(3))
    compare_cycles("4-way sharded vs single card", ts_sh, m_sh, ts_1, m_1, init_groups)

    # GSPMD dp x tp on a 2x2 mesh, at the multichip dry run's width (the
    # path under test is the sharding of the wide layers, not the width)
    mesh = make_dp_tp_mesh(2, 2)
    cfg = ResnetGANConfig(algorithm="rcgan-u", dim_g=16, dim_d=16, embedding_dim=24)
    acfg = CifarAlgoConfig(algorithm="rcgan-u", perm_classifier=True, confuse_init=True)
    tr = CifarTrainer(cfg, acfg, tcfg, c, mesh=None, compute_dtype=jnp.bfloat16)
    ts = tr.init(jax.random.key(0), 64)
    ts = apply_shardings(ts, train_state_shardings(mesh, ts))
    step = gspmd_cycle(tr, mesh)
    d_batches, g_labels = _cycle_inputs(tr, 64, seed=3)
    for it in (1, 2):
        ts, m = step(ts, d_batches, g_labels, jnp.asarray(it, jnp.int32), jax.random.key(it))
        costs = {k: float(m[k]) for k in ("d_cost", "g_cost")}
        assert all(np.isfinite(v) for v in costs.values()), costs
    log(f"  GSPMD dp x tp 2x2 rcgan-u bf16 (dim 16): 2 cycles, finite costs {costs}")


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    device = phase_device(args)
    if args.chips == 4:
        phase_multichip()
    else:
        host = HostCycle()
        host.start()
        phase_ops()
        phase_forward()
        compare_host_cycle = phase_cycle(host)
        phase_apps()
        compare_host_cycle()
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    print(last_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
