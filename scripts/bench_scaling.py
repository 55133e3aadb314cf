"""Arithmetic-intensity scaling study: is the flagship config's share of
peak a property of the WORKLOAD (reference batch 64, dim 128) or of the
framework?

Benches the fused 1G+5D cycle at batch {64, 128, 256} (and optionally
dim 256) and reports cycles/s, achieved TFLOP/s, % of the card's bf16
peak, and — when the static-unroll cycle is compiled (--bytes) — achieved
GB/s and % of its HBM peak (peaks from ``utils/profiling.PEAKS``).  If the
share rises with batch, the ceiling is the reference workload.

On the GPU:       python scripts/bench_scaling.py --out runs/scaling.json
Rehearse on CPU:  JAX_PLATFORMS=cpu python scripts/bench_scaling.py --tiny
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))



def timed_rate(fn, n=30, windows=3):
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        rates.append(n / (time.perf_counter() - t0))
    return float(np.median(rates))


def bench_config(batch, dim, dtype, want_bytes, peak):
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu.data.confusion import one_coin_matrix
    from rcgan_tpu.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

    cfg = ResnetGANConfig(dim_g=dim, dim_d=dim)
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
    it = jnp.asarray(1, jnp.int32)
    full = jax.jit(lambda ts_, rng: tr._cycle(ts_, d_batches, g_labels, it, rng,
                                              None, None)[1]["d_cost"])
    full(ts, jax.random.key(1))  # compile+warm
    rate = timed_rate(lambda: full(ts, jax.random.key(2)))

    # flops from the lowered static-unroll cycle (scan body counted n_critic
    # times — see bench.py module docstring for why the rolled count is ~2x low)
    unrolled = jax.jit(lambda ts_, rng: tr._cycle(ts_, d_batches, g_labels, it, rng,
                                                  None, None, static_unroll=True))
    from rcgan_tpu.utils.profiling import xla_cost

    flops = float(xla_cost(unrolled, ts, jax.random.key(1), compiled=False)["flops"])
    bytes_acc = None
    if want_bytes:
        c = xla_cost(unrolled, ts, jax.random.key(1))
        bytes_acc = float(c.get("bytes accessed", 0.0))
        flops = float(c["flops"])  # post-optimization count

    row = {
        "batch": batch,
        "dim": dim,
        "cycles_per_sec": round(rate, 3),
        "ms_per_cycle": round(1e3 / rate, 2),
        "gflops_per_cycle": round(flops / 1e9, 1),
        "tflops_per_sec": round(rate * flops / 1e12, 2),
        "pct_bf16_peak": 100 * rate * flops / 1e12 / peak["bf16_tflops"],
    }
    if bytes_acc:
        row["gbytes_per_cycle"] = round(bytes_acc / 1e9, 2)
        row["gbps"] = round(rate * bytes_acc / 1e9, 1)
        row["pct_hbm_peak"] = 100 * rate * bytes_acc / 1e12 / peak["hbm_tbps"]
        row["arithmetic_intensity_flops_per_byte"] = round(flops / bytes_acc, 1)
    print(json.dumps(row))
    return row


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true", help="tiny dims (CPU rehearsal)")
    p.add_argument("--bytes", action="store_true", default=True,
                   help="compile the static-unroll cycle for true bytes "
                        "(slower per config; default on)")
    p.add_argument("--no-bytes", dest="bytes", action="store_false")
    p.add_argument("--batches", default=None, help="comma list, e.g. 64,128,256")
    p.add_argument("--dims", default=None, help="comma list of widths paired "
                   "with --dim_batch (extra rows)")
    p.add_argument("--dim_batch", type=int, default=64)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    global jax
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.utils.compilation_cache import enable as enable_xla_cache
    from rcgan_tpu.utils.profiling import device_info, peaks

    enable_xla_cache()
    device = device_info()
    print(f"device: {device}")
    nan = float("nan")
    peak = ({"bf16_tflops": nan, "hbm_tbps": nan} if args.tiny else peaks(device["kind"]))

    dtype = jnp.float32 if args.tiny else jnp.bfloat16
    if args.tiny:
        batches = [4, 8]
        dims = []
        base_dim = 16
    else:
        batches = [int(x) for x in (args.batches or "64,128,256").split(",")]
        dims = [int(x) for x in args.dims.split(",")] if args.dims else [256]
        base_dim = 128

    # one failing config (OOM at the largest batch, a compile timeout at
    # dim 256) must not lose the rows already measured — this runs
    # unattended with an outer timeout, so flush after every row
    rows = []

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=2)
                f.write("\n")

    for b, d in [(b, base_dim) for b in batches] + [(args.dim_batch, d) for d in dims]:
        try:
            rows.append(bench_config(b, d, dtype, args.bytes, peak))
        except Exception as e:  # noqa: BLE001
            print(f"  (config batch={b} dim={d} failed: {type(e).__name__}: {e})")
            rows.append({"batch": b, "dim": d, "error": f"{type(e).__name__}: {e}"})
        flush()
    if args.out:
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
