"""Serving latency/throughput microbench.

Measures, on a restored flagship checkpoint (or a tiny fresh model with
``--smoke``):

  * per-bucket request latency: p50 / p95 / p99 over ``--reqs`` calls of
    ``Sampler.sample`` at each bucket's exact size (no padding waste), plus
    the cold (first-call compile) time per bucket;
  * dispatch floor: a trivial 1-element device round trip, the lower
    bound any request pays regardless of model size;
  * coalesced throughput: ``--threads`` concurrent submitters pushing
    size-``--req_size`` requests through ``serving.Coalescer`` for
    ``--secs`` seconds -> samples/sec and mean batched-dispatch size
    (the batching the reference's feed_dict server could not do:
    `cifar10/gan_resnet.py` has no serving path at all; this framework's
    is `rcgan_tpu/serving.py`).

Writes ``runs/serving_latency.json`` (or ``--out``) and prints a
table.  Rehearse on CPU with ``JAX_PLATFORMS=cpu ... --smoke``.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pct(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def build_sampler(args):
    import jax

    from rcgan_tpu import serving

    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.smoke:
        from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
        from rcgan_tpu.data.confusion import one_coin_matrix
        from rcgan_tpu.models.resnet_gan import ResnetGANConfig
        from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

        cfg = ResnetGANConfig(dim_g=32, dim_d=16)
        trainer = CifarTrainer(cfg, CifarAlgoConfig(algorithm="rcgan"),
                               CifarTrainConfig(), one_coin_matrix(0.6, 10))
        ts = trainer.init(jax.random.key(0), max(buckets))
        return serving.Sampler(trainer, ts, "cifar", buckets=buckets), buckets
    return (serving.Sampler.from_checkpoint(args.model, args.checkpoint,
                                            buckets=buckets), buckets)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="runs/round5/r5_rcgan_50k/checkpoint")
    ap.add_argument("--model", default="cifar")
    ap.add_argument("--buckets", default="1,8,64,256")
    ap.add_argument("--reqs", type=int, default=50)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--req_size", type=int, default=10)
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="runs/serving_latency.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rcgan_tpu import serving

    platform = jax.devices()[0].platform
    sampler, buckets = build_sampler(args)
    rng = np.random.default_rng(0)

    # dispatch RTT floor: tiny jitted identity round trip
    one = jnp.ones((1,), jnp.float32)
    tiny = jax.jit(lambda x: x + 1)
    np.asarray(tiny(one))  # compile
    rtts = []
    for _ in range(20):
        t0 = time.perf_counter()
        np.asarray(tiny(one))
        rtts.append(time.perf_counter() - t0)
    rtt_ms = 1e3 * pct(rtts, 50)

    rows = []
    for b in buckets:
        labels = (np.arange(b) % 10).astype(np.int32)
        t0 = time.perf_counter()
        sampler.sample(labels, rng=jax.random.key(1))  # cold: bucket compile
        cold_s = time.perf_counter() - t0
        lats = []
        for i in range(args.reqs):
            t0 = time.perf_counter()
            out = sampler.sample(labels, rng=jax.random.key(i))
            lats.append(time.perf_counter() - t0)
        assert out.shape[0] == b
        rows.append({
            "bucket": b, "cold_compile_s": round(cold_s, 3),
            "p50_ms": round(1e3 * pct(lats, 50), 2),
            "p95_ms": round(1e3 * pct(lats, 95), 2),
            "p99_ms": round(1e3 * pct(lats, 99), 2),
            "samples_per_sec_serial": round(b / pct(lats, 50), 1),
        })
        print(f"bucket {b:4d}: cold {cold_s:6.2f}s  p50 {rows[-1]['p50_ms']:8.2f}ms  "
              f"p95 {rows[-1]['p95_ms']:8.2f}ms  serial {rows[-1]['samples_per_sec_serial']:8.1f} samp/s")

    # coalesced throughput
    metrics = serving.ServingMetrics()
    co = serving.Coalescer(sampler, max_wait_ms=4.0, metrics=metrics)
    done = threading.Event()
    counts = [0] * args.threads

    def worker(i):
        n = 0
        labels = ((np.arange(args.req_size) + i) % 10).tolist()
        while not done.is_set():
            co.submit(labels, seed=n * args.threads + i)
            n += 1
        counts[i] = n

    # warm the coalescer's bucket before timing
    co.submit(list(range(args.req_size)), seed=0)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(args.threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.secs)
    done.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    co.close()
    total_reqs = sum(counts)
    snap = metrics.snapshot()
    coalesced = {
        "threads": args.threads, "req_size": args.req_size,
        "wall_s": round(wall, 2), "requests": total_reqs,
        "samples_per_sec": round(total_reqs * args.req_size / wall, 1),
        "requests_per_sec": round(total_reqs / wall, 1),
    }
    print(f"coalesced: {coalesced['samples_per_sec']} samp/s "
          f"({coalesced['requests_per_sec']} req/s x {args.req_size}) "
          f"with {args.threads} submitters")

    out = {
        "platform": platform, "smoke": bool(args.smoke),
        "checkpoint": None if args.smoke else args.checkpoint,
        "dispatch_rtt_ms_p50": round(rtt_ms, 2),
        "per_bucket": rows, "coalesced": coalesced,
        "serving_metrics": snap,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
