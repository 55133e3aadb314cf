"""Breakdown of the flagship CIFAR fused cycle: time each component of the
1G+5D cycle as its own compiled program, pull XLA cost-analysis flops/bytes
for each, and print a roofline table (achieved TFLOP/s vs the card's bf16
peak, achieved GB/s vs its HBM peak; peaks from ``utils/profiling.PEAKS``).

On the GPU:       python scripts/profile_cycle.py
Rehearse on CPU:  JAX_PLATFORMS=cpu python scripts/profile_cycle.py --tiny
                  (no peak columns: a CPU has no entry in the peak table)

The per-piece rates attribute the cycle wall-clock: cycle ~= g_step +
n_critic * d_step (+ jitter).  ``--trace_dir`` also writes a jax.profiler
trace of three full cycles.

FLOP-counting subtlety (discovered round 3): XLA's ``cost_analysis()``
counts a ``lax.scan``/while-loop body ONCE regardless of trip count and a
``lax.cond`` as its max branch, so the rolled cycle's counted flops miss
n_critic-1 of the D bodies (~2x under-report at the flagship config).  The
honest per-cycle number comes from the numerically-identical
``static_unroll`` variant (``train/cifar_loop.py``), reported here as
``full_cycle(unrolled count)``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))



def timed_rate(fn, n=50, windows=3):
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        rates.append(n / (time.perf_counter() - t0))
    return float(np.median(rates))


def cost(jitted, *args):
    from rcgan_tpu.utils.profiling import xla_cost

    c = xla_cost(jitted, *args)
    return float(c["flops"]), float(c.get("bytes accessed", 0.0))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true", help="tiny dims (CPU rehearsal)")
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--out", default=None, help="write the table as JSON here")
    p.add_argument("--compile_unrolled", action="store_true",
                   help="also COMPILE the static-unroll cycle for a "
                        "post-optimization flops+bytes count (slow: the "
                        "body is ~5x the rolled program; the lowered-HLO "
                        "flop count is always reported and is within ~2%)")
    args = p.parse_args()

    global jax
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.utils.profiling import device_info, peaks

    device = device_info()
    print(f"device: {device}")
    if args.tiny:
        peak_tf, peak_gbps = float("nan"), float("nan")
    else:
        peak = peaks(device["kind"])
        peak_tf, peak_gbps = peak["bf16_tflops"], peak["hbm_tbps"] * 1e3

    from rcgan_tpu.algorithms.cifar import CifarAlgoConfig, disc_loss, gen_loss
    from rcgan_tpu.core.module import Ctx, merge
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.models.resnet_gan import ResnetGANConfig, discriminator, generator
    from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

    dim = 16 if args.tiny else 128
    batch = 8 if args.tiny else 64
    emb = 24 if args.tiny else 300
    dtype = jnp.float32 if args.tiny else jnp.bfloat16
    cfg = ResnetGANConfig(dim_g=dim, dim_d=dim, embedding_dim=emb)
    acfg = CifarAlgoConfig(algorithm="rcgan", loss_type="HINGE")
    tcfg = CifarTrainConfig(n_critic=5, gen_bs_multiple=2)
    tr = CifarTrainer(cfg, acfg, tcfg, one_coin_matrix(0.6, 10), compute_dtype=dtype)
    ts = tr.init(jax.random.key(0), batch)

    rs = np.random.RandomState(0)
    nc = tcfg.n_critic
    d_batches = {
        "images": jnp.asarray(rs.randint(0, 256, (nc, batch, cfg.output_dim)), jnp.int32),
        "labels": jnp.asarray(rs.randint(0, 10, (nc, batch)), jnp.int32),
        "labels_random": jnp.asarray(rs.randint(0, 10, (nc, batch)), jnp.int32),
        "labels_biased": jnp.asarray(rs.randint(0, 10, (nc, batch)), jnp.int32),
        "labels_inv_weights": jnp.asarray(rs.rand(nc, batch, 10), jnp.float32),
    }
    gb = tcfg.gen_bs_multiple * batch
    g_labels = {
        "random": jnp.asarray(rs.randint(0, 10, (gb,)), jnp.int32),
        "biased": jnp.asarray(rs.randint(0, 10, (gb,)), jnp.int32),
    }
    params = ts.params
    state = ts.state
    rows = []

    def piece(name, jitted, *pargs, per_cycle=1.0):
        jitted(*pargs)  # compile+warm
        rate = timed_rate(lambda: jitted(*pargs))
        fl, by = cost(jitted, *pargs)
        rows.append({
            "piece": name, "per_cycle": per_cycle, "rate_per_sec": rate,
            "ms_per_call": 1e3 / rate, "gflops_per_call": fl / 1e9,
            "tflops_per_sec": rate * fl / 1e12, "gbytes_per_call": by / 1e9,
            "gbps": rate * by / 1e9,
            "pct_bf16_peak": 100 * rate * fl / 1e12 / peak_tf,
            "pct_hbm_peak": 100 * rate * by / 1e9 / peak_gbps,
        })
        print(f"{name:28s} {1e3/rate:8.2f} ms  {rate*fl/1e12:7.2f} TF/s "
              f"({100*rate*fl/1e12/peak_tf:5.1f}% bf16 peak)  "
              f"{rate*by/1e9:7.1f} GB/s ({100*rate*by/1e9/peak_gbps:5.1f}% HBM peak)")

    # ---- full cycle
    it = jnp.asarray(1, jnp.int32)
    full = jax.jit(lambda ts_, rng: tr._cycle(ts_, d_batches, g_labels, it, rng,
                                              None, None)[1]["d_cost"])
    piece("full_cycle(1G+5D)", full, ts, jax.random.key(1))

    # ---- counted-but-not-run static-unroll cycle: XLA cost_analysis counts
    # a lax.scan body ONCE (and a lax.cond as its max branch), so the rolled
    # program's "flops" under-reports the true per-cycle work ~2x.  The
    # static_unroll variant is numerically identical straight-line code
    # (tests/test_train.py::test_cifar_static_unroll_matches_rolled); its
    # lowered-HLO count is the honest flops/cycle denominator-free number.
    unrolled = jax.jit(lambda ts_, rng: tr._cycle(ts_, d_batches, g_labels, it, rng,
                                                  None, None, static_unroll=True))
    from rcgan_tpu.utils.profiling import xla_cost

    true_flops = float(xla_cost(unrolled, ts, jax.random.key(1), compiled=False)["flops"])
    cyc = rows[0]
    rate = cyc["rate_per_sec"]
    rows.append({
        "piece": "full_cycle(unrolled count)", "per_cycle": 1.0,
        "rate_per_sec": rate, "ms_per_call": cyc["ms_per_call"],
        "gflops_per_call": true_flops / 1e9,
        "tflops_per_sec": rate * true_flops / 1e12,
        "gbytes_per_call": None, "gbps": None,
        "pct_bf16_peak": 100 * rate * true_flops / 1e12 / peak_tf,
        "pct_hbm_peak": None,
        "note": "flops from the lowered static-unroll program (scan body "
                "counted n_critic times); timing is the rolled hot path",
    })
    print(f"{'full_cycle(unrolled count)':28s} {cyc['ms_per_call']:8.2f} ms  "
          f"{rate*true_flops/1e12:7.2f} TF/s "
          f"({100*rate*true_flops/1e12/peak_tf:5.1f}% bf16 peak)  "
          f"[true flops/cycle = {true_flops/1e9:.0f} GF]")
    if args.compile_unrolled:
        fl_u, by_u = cost(unrolled, ts, jax.random.key(1))
        rows.append({
            "piece": "full_cycle(unrolled compiled)", "per_cycle": 1.0,
            "rate_per_sec": rate, "ms_per_call": cyc["ms_per_call"],
            "gflops_per_call": fl_u / 1e9, "tflops_per_sec": rate * fl_u / 1e12,
            "gbytes_per_call": by_u / 1e9, "gbps": rate * by_u / 1e9,
            "pct_bf16_peak": 100 * rate * fl_u / 1e12 / peak_tf,
            "pct_hbm_peak": 100 * rate * by_u / 1e9 / peak_gbps,
            "note": "post-optimization count of the straight-line cycle: "
                    "the true per-cycle flops AND bytes",
        })
        print(f"{'full_cycle(unrolled compiled)':28s} {cyc['ms_per_call']:8.2f} ms  "
              f"{rate*fl_u/1e12:7.2f} TF/s "
              f"({100*rate*fl_u/1e12/peak_tf:5.1f}% bf16 peak)  "
              f"{rate*by_u/1e9:7.1f} GB/s ({100*rate*by_u/1e9/peak_gbps:5.1f}% HBM peak)")

    # ---- one D micro-step: loss + grad wrt the DISC group only, exactly the
    # scan body's differentiation structure (an earlier revision of this
    # script differentiated wrt ALL params, which silently added the full
    # generator backward to the "d_step" piece — ~2x its true flops).
    sb = {
        "real_data": jnp.asarray(rs.rand(batch, cfg.output_dim) * 2 - 1, dtype),
        "labels": d_batches["labels"][0],
        "labels_random": d_batches["labels_random"][0],
        "labels_biased": d_batches["labels_biased"][0],
        "labels_inv_weights": d_batches["labels_inv_weights"][0],
    }
    z64 = jnp.asarray(rs.randn(batch, cfg.z_dim), jnp.float32)
    groups0 = ts.groups

    def d_grad(d_params, st):
        def f(dp):
            parts = [g for n, g in groups0.items() if n != "disc"]
            ctx = Ctx(params=merge(*parts, dp), state=st, init=False, train=True,
                      update_sn=True, compute_dtype=dtype)
            return disc_loss(ctx, cfg, acfg, sb, z64, tr.confusion_actual)["disc_cost"]
        return jax.grad(f)(d_params)

    piece("d_step(loss+grad wrt D)", jax.jit(d_grad), groups0["disc"], state, per_cycle=5.0)

    # ---- G step (loss + grad wrt the GEN group only, at gen batch 128)
    zg = jnp.asarray(rs.randn(gb, cfg.z_dim), jnp.float32)

    def g_grad(g_params, st):
        def f(gp):
            parts = [g for n, g in groups0.items() if n != "gen"]
            ctx = Ctx(params=merge(*parts, gp), state=st, init=False, train=True,
                      update_sn=True, compute_dtype=dtype)
            return gen_loss(ctx, cfg, acfg, g_labels["random"], g_labels["biased"],
                            zg, tr.confusion_actual)["gen_cost"]
        return jax.grad(f)(g_params)

    piece("g_step(loss+grad wrt G)", jax.jit(g_grad), groups0["gen"], state)

    # ---- forward-only pieces
    def gen_fwd(p, st, z, lab):
        ctx = Ctx(params=p, state=st, init=False, train=True, update_sn=False,
                  compute_dtype=dtype)
        return generator(ctx, cfg, z, lab)

    piece("generator_fwd(b64)", jax.jit(gen_fwd), params, state, z64,
          d_batches["labels_random"][0], per_cycle=5.0)
    piece("generator_fwd(b128)", jax.jit(gen_fwd), params, state, zg,
          g_labels["random"])

    def disc_fwd(p, st, x, lab):
        ctx = Ctx(params=p, state=st, init=False, train=True, update_sn=False,
                  compute_dtype=dtype)
        return discriminator(ctx, cfg, x, lab)[1]

    x128 = jnp.asarray(rs.rand(2 * batch, cfg.output_dim) * 2 - 1, dtype)
    piece("disc_fwd(b128)", jax.jit(disc_fwd), params, state, x128,
          jnp.concatenate([sb["labels"], sb["labels_random"]]), per_cycle=5.0)

    # ---- attribution check
    by = {r["piece"]: r for r in rows}
    attributed = (by["g_step(loss+grad wrt G)"]["ms_per_call"]
                  + 5 * by["d_step(loss+grad wrt D)"]["ms_per_call"])
    print(f"\nattribution: g_step + 5*d_step = {attributed:.2f} ms vs full cycle "
          f"{by['full_cycle(1G+5D)']['ms_per_call']:.2f} ms "
          f"(residual = Adam updates, SN state plumbing, scan overhead, and "
          f"whole-cycle fusion savings vs standalone grad materialization)")

    if args.trace_dir:
        from rcgan_tpu.utils.profiling import trace
        with trace(args.trace_dir):
            for _ in range(3):
                out = full(ts, jax.random.key(3))
            jax.block_until_ready(out)
        print(f"trace written under {args.trace_dir}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
