"""Headline benchmark: CIFAR-10 SNGAN fused train cycles/sec on one GPU.

One cycle = 1 generator step (+ confusion step) + N_CRITIC=5 discriminator
steps at the reference's full size (batch 64, DIM_G=DIM_D=128, z=128,
HINGE loss, projection discriminator, spectral norm) — the unit of the
reference hot loop (``cifar10/gan_resnet.py:919-947``).

Needs a GPU: on any other platform it exits non-zero and prints no result.
Output is ONE self-describing JSON line.  Fields:

- ``device``: platform, ``device_kind`` and device count as JAX reports
  them; ``power_limit``: the card's name and power limit from
  ``nvidia-smi`` (a card set below its maximum runs slower under load).
- ``value`` / ``unit``: measured fused cycles/sec — the best of the
  per-dispatch path and the app-default 100-cycle scan-block path (both
  under ``extra_metrics``; median of 3 timing windows; the value fetch is
  the end-of-work barrier).
- ``tflops_per_sec`` / ``pct_of_bf16_peak``: achieved compute rate
  (flops/cycle x cycles/sec) and its fraction of the card's published
  dense bf16 peak (``utils/profiling.PEAKS``, keyed by ``device_kind``).
  flops/cycle is XLA's own count of the STATIC-UNROLL variant of the cycle
  (``flops_source: "xla_lowered_unrolled"``): cost_analysis() counts a
  lax.scan body once regardless of trip count, so counting the rolled hot
  program would drop n_critic-1 of the 5 D steps (that rolled count is
  still surfaced as ``flops_per_cycle_rolled_scan``).  The unrolled variant
  is numerically identical straight-line code
  (tests/test_train.py::test_cifar_static_unroll_matches_rolled) and is
  only lowered, never run.  A failed count is an error.
- ``vs_baseline`` with ``vs_baseline_is_estimate: true``: the reference
  publishes no steps/sec (BASELINE.md), so the denominator is a documented
  ESTIMATE of its single-GPU rate — the TF1.5 feed_dict loop ran 6 session
  calls per cycle with host->device copies of the batch + 5 label tensors
  each; ~1.0 cycles/sec is a generous estimate for the 2018-class single
  GPU the paper used.
- ``extra_metrics.mnist_*``: the MNIST stack's fused iteration (1 D step +
  2x(G+C) steps, batch 100 — ``mnist/model.py:335-467``), split like the
  CIFAR bench: ``mnist_per_dispatch_iters_per_sec`` (one program dispatch
  per iteration) vs ``mnist_scan_block50_iters_per_sec`` (the app's
  default 50-iteration fused ``lax.scan`` path);
  ``mnist_dispatch_overhead_ms`` is the difference per iteration.
"""

import json
import sys
import time

import numpy as np

REFERENCE_CYCLES_PER_SEC = 1.0  # documented estimate; see module docstring


def _timed_rate(run_one, n_iters=100, windows=3):
    """Median over ``windows`` of ``n_iters`` calls/sec; ``run_one`` must
    return something materializable as the sync barrier."""
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        last = None
        for _ in range(n_iters):
            last = run_one()
        float(last)  # materialize: the only true end-of-work barrier
        rates.append(n_iters / (time.perf_counter() - t0))
    return float(np.median(rates))


def cifar_setup(batch=64, algorithm="rcgan", dim=128, compute_dtype=None, seed=0):
    """The benchmark's CIFAR cycle: trainer, initial state and one cycle's
    seeded inputs (``d_batches`` [n_critic, B], ``g_labels`` [2B])."""
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

    cfg = ResnetGANConfig(dim_g=dim, dim_d=dim, algorithm=algorithm)
    acfg = CifarAlgoConfig(algorithm=algorithm, loss_type="HINGE",
                           perm_classifier=algorithm == "rcgan-u")
    tcfg = CifarTrainConfig(n_critic=5, gen_bs_multiple=2)
    trainer = CifarTrainer(cfg, acfg, tcfg, one_coin_matrix(0.6, 10), mesh=None,
                           compute_dtype=compute_dtype or jnp.bfloat16)
    ts = trainer.init(jax.random.key(seed), batch)

    rs = np.random.RandomState(seed)
    d_batches = {
        "images": jnp.asarray(rs.randint(0, 256, (tcfg.n_critic, batch, 3072)), jnp.int32),
        "labels": jnp.asarray(rs.randint(0, 10, (tcfg.n_critic, batch)), jnp.int32),
        "labels_random": jnp.asarray(rs.randint(0, 10, (tcfg.n_critic, batch)), jnp.int32),
        "labels_biased": jnp.asarray(rs.randint(0, 10, (tcfg.n_critic, batch)), jnp.int32),
        "labels_inv_weights": jnp.asarray(rs.rand(tcfg.n_critic, batch, 10), jnp.float32),
    }
    g_labels = {
        "random": jnp.asarray(rs.randint(0, 10, (tcfg.gen_bs_multiple * batch,)), jnp.int32),
        "biased": jnp.asarray(rs.randint(0, 10, (tcfg.gen_bs_multiple * batch,)), jnp.int32),
    }
    return trainer, ts, d_batches, g_labels


def bench_cifar():
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.utils.profiling import xla_cost

    trainer, ts, d_batches, g_labels = cifar_setup()
    cfg, acfg, tcfg = trainer.cfg, trainer.acfg, trainer.tcfg
    batch = d_batches["labels"].shape[1]

    it1 = jnp.asarray(1, jnp.int32)
    # True per-cycle flops: count the numerically-identical static-unroll
    # cycle (lowered only, never compiled/run) — the rolled program's count
    # misses n_critic-1 scan-body repetitions (see module docstring).
    unrolled = jax.jit(
        lambda t, r: trainer._cycle(t, d_batches, g_labels, it1, r, None, None,
                                    static_unroll=True)
    )
    flops_per_cycle = xla_cost(unrolled, ts, jax.random.key(1), compiled=False)["flops"]
    flops_rolled = xla_cost(
        trainer._jitted_cycle, ts, d_batches, g_labels, it1, jax.random.key(1), None,
    )["flops"]

    state = {"ts": ts, "rng": jax.random.key(1), "it": 1}

    def run_one():
        state["rng"], sub = jax.random.split(state["rng"])
        state["ts"], m = trainer.step(state["ts"], d_batches, g_labels, state["it"], sub)
        state["it"] += 1
        return m["d_cost"]

    run_one()  # warmup / compile
    float(state["ts"].step)  # sync before timing
    cycles_per_sec = _timed_rate(run_one)

    # ---- fused scan-block path (the app's default hot loop): K cycles per
    # dispatch over a device-resident dataset.
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.train.cifar_loop import CifarTrainer

    K = 100  # the app-default scan block (config.py --scan_block)
    rs2 = np.random.RandomState(3)
    n_data = 4096
    dd = {
        "images": rs2.randint(0, 256, (n_data, 3072)).astype(np.uint8),
        "labels": rs2.randint(0, 10, n_data).astype(np.int32),
        "labels_random": rs2.randint(0, 10, n_data).astype(np.int32),
        "labels_biased": rs2.randint(0, 10, n_data).astype(np.int32),
        "labels_inv_weights": rs2.rand(n_data, 10).astype(np.float32),
    }
    tr2 = CifarTrainer(cfg, acfg, tcfg, one_coin_matrix(0.6, 10), mesh=None,
                       compute_dtype=jnp.bfloat16, device_dataset=dd)
    ts2 = tr2.init(jax.random.key(0), batch)
    idx = rs2.randint(0, n_data, (K, tcfg.n_critic, batch)).astype(np.int32)
    g_r = rs2.randint(0, 10, (K, tcfg.gen_bs_multiple * batch)).astype(np.int32)
    g_b = rs2.randint(0, 10, (K, tcfg.gen_bs_multiple * batch)).astype(np.int32)
    st2 = {"ts": ts2, "rng": jax.random.key(4)}

    def run_block():
        st2["rng"], sub = jax.random.split(st2["rng"])
        st2["ts"], ms = tr2.step_scan(st2["ts"], idx, g_r, g_b, sub)
        return ms["d_cost"][-1]

    run_block()
    float(st2["ts"].step)
    scan_cycles_per_sec = K * _timed_rate(run_block, n_iters=10)
    return cycles_per_sec, scan_cycles_per_sec, flops_per_cycle, flops_rolled


def bench_mnist():
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.models.dcgan import DCGANConfig
    from rcgan_tpu.train.mnist_loop import MnistTrainer, MnistTrainConfig

    batch = 100
    trainer = MnistTrainer(
        DCGANConfig(disc_type="projection"),
        MnistAlgoConfig(algorithm="rcgan", loss_fn="hinge"),
        MnistTrainConfig(),
        one_coin_matrix(0.3, 10),
        mesh=None,
        compute_dtype=jnp.bfloat16,
    )
    rs = np.random.RandomState(1)
    mk_labels = lambda: jnp.asarray(rs.randint(0, 10, (batch,)), jnp.int32)
    b = {
        "images": jnp.asarray(rs.rand(batch, 28, 28, 1), jnp.float32),
        "y_real": mk_labels(),
        "y_gen": mk_labels(),
        "y_fake": mk_labels(),
        "y_real_weights": jnp.asarray(rs.rand(batch, 10), jnp.float32),
    }
    ts = trainer.init(jax.random.key(0), b)
    state = {"ts": ts, "rng": jax.random.key(2)}

    def run_one():
        state["rng"], sub = jax.random.split(state["rng"])
        state["ts"], m = trainer.step(state["ts"], b, sub)
        return m["d_loss"]

    run_one()  # warmup / compile
    float(state["ts"].step)
    per_dispatch = _timed_rate(run_one)

    # ---- fused 50-iteration scan blocks over a device-resident dataset —
    # the app's actual default hot loop (mnist_app.py use_scan path), one
    # dispatch per 50 iterations.
    K = 50
    n_data = 4000
    rs2 = np.random.RandomState(7)
    dataset = {
        "images": jnp.asarray(rs2.rand(n_data, 28, 28, 1), jnp.float32),
        "y_real": jnp.asarray(rs2.randint(0, 10, n_data), jnp.int32),
        "y_gen": jnp.asarray(rs2.randint(0, 10, n_data), jnp.int32),
        "y_fake": jnp.asarray(rs2.randint(0, 10, n_data), jnp.int32),
        "y_real_weights": jnp.asarray(rs2.rand(n_data, 10), jnp.float32),
    }
    idx = rs2.randint(0, n_data, (K, batch)).astype(np.int32)
    st2 = {"ts": state["ts"], "rng": jax.random.key(8)}

    def run_block():
        st2["rng"], sub = jax.random.split(st2["rng"])
        st2["ts"], ms = trainer.step_scan(st2["ts"], dataset, idx, sub)
        return ms["d_loss"][-1]

    run_block()
    float(st2["ts"].step)
    scan_rate = K * _timed_rate(run_block, n_iters=10)
    # per-iteration dispatch overhead: per-dispatch time minus scanned time
    overhead_ms = (1.0 / per_dispatch - 1.0 / scan_rate) * 1e3
    return per_dispatch, scan_rate, overhead_ms


def main():
    import jax

    from rcgan_tpu.utils.compilation_cache import enable as enable_xla_cache
    from rcgan_tpu.utils.profiling import device_info, gpu_name_and_power_limit, peaks

    device = device_info()
    if device["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {device}", file=sys.stderr)
        sys.exit(1)
    peak_tflops = peaks(device["kind"])["bf16_tflops"]
    power_limit = gpu_name_and_power_limit()
    enable_xla_cache()

    cycles_per_sec, scan_cycles_per_sec, flops_per_cycle, flops_rolled = bench_cifar()
    mnist_per_dispatch, mnist_scan, mnist_overhead_ms = bench_mnist()
    best_cycles = max(cycles_per_sec, scan_cycles_per_sec)
    print(
        f"# mnist: per-dispatch {mnist_per_dispatch:.1f} it/s vs fused-scan "
        f"{mnist_scan:.1f} it/s -> dispatch overhead {mnist_overhead_ms:.3f} ms/iter",
        flush=True,
    )

    print(
        json.dumps(
            {
                "metric": "cifar10_sngan_train_cycles_per_sec_per_chip",
                "device": device,
                "power_limit": power_limit,
                "jax_version": jax.__version__,
                "value": best_cycles,
                "unit": "cycles/s (1 G + 5 D steps, batch 64, dim 128)",
                "vs_baseline": best_cycles / REFERENCE_CYCLES_PER_SEC,
                "vs_baseline_is_estimate": True,
                "baseline_estimate_cycles_per_sec": REFERENCE_CYCLES_PER_SEC,
                "tflops_per_sec": best_cycles * flops_per_cycle / 1e12,
                "pct_of_bf16_peak": 100.0 * best_cycles * flops_per_cycle / 1e12 / peak_tflops,
                "bf16_peak_tflops": peak_tflops,
                "flops_per_cycle": flops_per_cycle,
                "flops_source": "xla_lowered_unrolled",
                "flops_per_cycle_rolled_scan": flops_rolled,
                "extra_metrics": {
                    "per_dispatch_cycles_per_sec": cycles_per_sec,
                    "scan_block100_cycles_per_sec": scan_cycles_per_sec,
                    "mnist_fused_iters_per_sec": max(mnist_per_dispatch, mnist_scan),
                    "mnist_per_dispatch_iters_per_sec": mnist_per_dispatch,
                    "mnist_scan_block50_iters_per_sec": mnist_scan,
                    "mnist_dispatch_overhead_ms": mnist_overhead_ms,
                    "mnist_unit": "iters/s (1 D + 2x(G+C) steps, batch 100)",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
