"""What XLA makes of the five ops that once had hand-written kernels, on the
card: each op's device time at the flagship shapes (forward and backward,
bf16), its roofline share, and its share of the device time of
``bench.py``'s full-size rcgan cycle.

    python scripts/profile_ops.py                   # on the GPU
    JAX_PLATFORMS=cpu python scripts/profile_ops.py --tiny   # CPU rehearsal

Device times come from jax.profiler traces (utils/profiling.py): the busy
time of one op's calls divided by their number.  The roofline is the larger
of the op's FLOPs over the bf16 peak and its minimal bytes over the HBM
peak (``utils/profiling.PEAKS``); the same call measures what a large plain
bf16 matmul and a large copy reach, as the practical ceilings.  The cycle's
device time is split by the ``jax.named_scope`` each op carries (``conv``,
``cond_bn``, ``sn``, ``all_label_logits``, ``dequantize``).  Writes JSON to
``--out`` and prints a table.
"""

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SCOPES = ("conv", "cond_bn", "sn", "all_label_logits", "dequantize")


def device_time_s(fn, args, trace_dir, plane, reps):
    """Seconds of device busy time per call of ``fn(*args)`` (already warm)."""
    import jax

    from rcgan_tpu.utils.profiling import busy_ns, device_events, latest_xplane, trace

    shutil.rmtree(trace_dir, ignore_errors=True)
    with trace(trace_dir):
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    path = latest_xplane(trace_dir)
    events = device_events(path, plane)
    if not events:
        raise RuntimeError(f"no XLA op events on planes {plane!r}:\n{describe(path)}")
    return busy_ns(events) / reps * 1e-9


def describe(xplane_path, per_line=3):
    """Planes, lines and a few events with their stats, for a trace whose
    layout the reduction did not expect."""
    import jax

    out = []
    for plane in jax.profiler.ProfileData.from_file(xplane_path).planes:
        out.append(f"plane {plane.name}")
        for line in plane.lines:
            evs = list(line.events)[:per_line]
            out.append(f"  line {line.name}: " + "; ".join(
                f"{e.name} {dict(e.stats)}" for e in evs))
    return "\n".join(out)


def host_time_s(fn, args, reps):
    """Wall seconds per call, dispatch included."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def fwd_bwd(f):
    """Forward and backward of ``f`` (cotangent ``ct`` for its output)."""
    import jax

    def run(*args):
        *primals, ct = args
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(ct)

    return jax.jit(run)


def op_cases(tiny):
    """(name, jitted fn, args, flops, minimal bytes) at the flagship shapes."""
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.core.module import Ctx
    from rcgan_tpu.core.rng import example_keys
    from rcgan_tpu.data.cifar10 import dequantize_chw_to_hwc_keys
    from rcgan_tpu.ops.conv import conv2d_lib
    from rcgan_tpu.ops.norm import cond_batchnorm
    from rcgan_tpu.ops.sn import spectral_normed_weight

    bf16 = jnp.bfloat16
    rs = np.random.RandomState(0)
    c = 8 if tiny else 128
    cases = []

    w = jnp.asarray(rs.randn(3, 3, c, c) / np.sqrt(9 * c), bf16)
    for batch in (64, 128):
        for size in ((8,) if tiny else (32, 16, 8)):
            x = jnp.asarray(rs.randn(batch, size, size, c), bf16)

            def conv(x, w):
                return conv2d_lib(Ctx(params={"c": {"Filters": w}}, compute_dtype=bf16),
                                  x, c, c, 3, 1, "c", biases=False)

            a = batch * size * size * c
            cases.append((f"conv3x3 b{batch} {size}x{size}x{c}", fwd_bwd(conv), (x, w, x),
                          3 * 2 * a * 9 * c, 2 * (6 * a + 3 * w.size)))

    b, s = (8, 8) if tiny else (128, 32)
    x = jnp.asarray(rs.randn(b, s, s, c), bf16)
    labels = jnp.asarray(rs.randint(0, 10, b), jnp.int32)
    scale_m = jnp.asarray(1 + 0.1 * rs.randn(10, c), jnp.float32)
    offset_m = jnp.asarray(0.1 * rs.randn(10, c), jnp.float32)

    def cbn(x, s_, o_):
        return cond_batchnorm(Ctx(params={"bn": {"scale": s_, "offset": o_}}), x, labels, 10, "bn")

    cases.append((f"cond_bn [{b},{s},{s},{c}]", fwd_bwd(cbn), (x, scale_m, offset_m, x),
                  13 * x.size, 2 * 5 * x.size))

    wsn = jnp.asarray(0.05 * rs.randn(3, 3, c, c), jnp.float32)
    u = jnp.asarray(rs.randn(1, c), jnp.float32)

    def sn(w_):
        return spectral_normed_weight(Ctx(state={"sn": {"u": u}}), "sn", w_)

    cases.append((f"sn [{9 * c},{c}] f32", fwd_bwd(sn), (wsn, wsn), 10 * wsn.size, 4 * 5 * wsn.size))

    feat = jnp.asarray(rs.randn(64, c), bf16)
    emb = jnp.asarray(rs.randn(10, c), bf16)
    wgan = jnp.asarray(rs.randn(64), bf16)
    ct = jnp.ones((64, 10), bf16)

    def proj(f, e, w_):
        return w_[:, None] + f @ e.T

    cases.append((f"all_label_logits [64,{c}]x[10,{c}]", fwd_bwd(proj), (feat, emb, wgan, ct),
                  3 * 2 * 64 * c * 10, 2 * (2 * 64 * c + 2 * 10 * c + 3 * 64 * 10)))

    images = jnp.asarray(rs.randint(0, 256, (64, 3072)), jnp.int32)
    keys = example_keys(jax.random.key(3), 64, None)
    cases.append(("dequantize [64,3072]", jax.jit(dequantize_chw_to_hwc_keys), (images, keys),
                  3 * images.size, 8 * images.size))
    return cases


def ceilings(tiny, trace_dir, plane):
    """Device rates of a large plain bf16 matmul and a large copy."""
    import jax
    import jax.numpy as jnp

    n = 256 if tiny else 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda x, y: x @ y)
    mm(a, a).block_until_ready()
    t_mm = device_time_s(mm, (a, a), trace_dir, plane, 10)
    big = jnp.ones(((1 << 20) if tiny else (1 << 28),), jnp.float32)  # 1 GiB on the card
    cp = jax.jit(lambda x: x * 1.0001)
    cp(big).block_until_ready()
    t_cp = device_time_s(cp, (big,), trace_dir, plane, 10)
    return {"matmul_bf16_tflops": 2 * n**3 / t_mm / 1e12,
            "copy_tbps": 2 * big.size * 4 / t_cp / 1e12, "matmul_n": n, "copy_bytes": big.size * 4}


def cycle_shares(tiny, trace_dir, plane, reps):
    """Share of the full-size rcgan cycle's device time by named scope."""
    import jax

    import bench
    from rcgan_tpu.utils.profiling import (attribute, busy_ns, device_events, hlo_scopes,
                                           latest_xplane, trace)

    trainer, ts, d_batches, g_labels = bench.cifar_setup(**({"dim": 8} if tiny else {}))
    it = jax.numpy.asarray(1, jax.numpy.int32)
    text = trainer._jitted_cycle.lower(ts, d_batches, g_labels, it, jax.random.key(1),
                                       None).compile().as_text()
    with open(os.path.join(os.path.dirname(trace_dir), "cycle_hlo.txt"), "w") as f:
        f.write(text)  # for reading the trace offline
    scopes_of = hlo_scopes(text, SCOPES)
    for i in range(2):  # compile + warm
        ts, m = trainer.step(ts, d_batches, g_labels, 1 + i, jax.random.key(i))
    jax.block_until_ready(m)
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with trace(trace_dir):
        for i in range(reps):
            ts, m = trainer.step(ts, d_batches, g_labels, 3 + i, jax.random.key(10 + i))
        jax.block_until_ready(m)
    wall = time.perf_counter() - t0
    events = device_events(latest_xplane(trace_dir), plane)
    busy = busy_ns(events)
    span = (max(e["start_ns"] + e["dur_ns"] for e in events) - min(e["start_ns"] for e in events))
    by_label = attribute(events, scopes_of)
    total = sum(by_label.values())
    return {
        "cycles": reps, "wall_s_traced": wall, "device_busy_ms_per_cycle": busy / reps / 1e6,
        "device_idle_share_of_span": 1 - busy / span, "kernel_ms_per_cycle": total / reps / 1e6,
        "kernels_per_cycle": len(events) / reps,
        "share_by_scope": {k: v / total for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])},
        "ms_per_cycle_by_scope": {k: v / reps / 1e6 for k, v in by_label.items()},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tiny", action="store_true", help="tiny shapes (CPU rehearsal)")
    p.add_argument("--out", default="runs/profile_ops.json")
    p.add_argument("--trace_dir", default="runs/profile_ops_traces")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import jax

    from rcgan_tpu.utils.compilation_cache import enable
    from rcgan_tpu.utils.profiling import device_info, gpu_name_and_power_limit, peaks

    enable()
    device = device_info()
    if args.tiny:
        plane = "/host:CPU"
        peak = {"bf16_tflops": float("nan"), "hbm_tbps": float("nan")}
        card = "none (CPU rehearsal)"
    else:
        if device["platform"] != "gpu":
            raise SystemExit(f"profile_ops.py needs a GPU; JAX found {device}")
        plane = "/device:GPU:"
        peak = peaks(device["kind"])
        card = gpu_name_and_power_limit()
    print(f"card: {card}; jax {jax.__version__}; {device}", flush=True)

    result = {"device": device, "card": card, "peak": peak,
              "ceilings": ceilings(args.tiny, os.path.join(args.trace_dir, "ceil"), plane)}
    print(f"ceilings: {result['ceilings']}", flush=True)
    rows = []
    for name, fn, fargs, flops, nbytes in op_cases(args.tiny):
        jax.block_until_ready(fn(*fargs))  # compile
        t_dev = device_time_s(fn, fargs, os.path.join(args.trace_dir, "op"), plane, args.reps)
        t_host = host_time_s(fn, fargs, args.reps)
        bound_s = max(flops / (peak["bf16_tflops"] * 1e12), nbytes / (peak["hbm_tbps"] * 1e12))
        bound = "compute" if flops / peak["bf16_tflops"] > nbytes / peak["hbm_tbps"] else "memory"
        row = {"op": name, "device_us": t_dev * 1e6, "host_us_per_call": t_host * 1e6,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "roofline_us": bound_s * 1e6,
               "roofline_share": bound_s / t_dev, "bound": bound}
        rows.append(row)
        print(f"{name:38s} device {row['device_us']:9.1f} us  host {row['host_us_per_call']:9.1f} us"
              f"  roofline {row['roofline_us']:8.2f} us ({row['bound']})"
              f"  share {row['roofline_share']:.3f}", flush=True)
    result["ops"] = rows
    result["cycle"] = cycle_shares(args.tiny, os.path.join(args.trace_dir, "cycle"), plane, 5)
    print(json.dumps(result["cycle"], indent=1), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
