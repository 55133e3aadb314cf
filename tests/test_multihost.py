"""Multi-host execution harness: two OS processes form a
real ``jax.distributed`` cluster over the gRPC coordination service — the
same code path a multi-host GPU deployment takes — build a global mesh
spanning both, feed per-host input shards via ``CifarSplit.epoch(shard=)``,
and run sharded training steps.  Costs must agree across processes AND match
a single-process single-device run on the same data (the DP-equivalence
property extended across process boundaries).

Reference parity: the reference's multi-GPU path is single-process in-graph
tower replication (``cifar10/gan_resnet.py:NGPUS``); multi-host is a
capability it does not have.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_step_matches_single(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own 2-device flag
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    results = {}
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, out[-4000:]
        _, pid, d1, g1, d2 = lines[-1].split()
        results[int(pid)] = (float(d1), float(g1), float(d2))
    # both controllers computed the same replicated metrics
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)

    # ---- single-process, single-device reference on the same data
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu.data.cifar10 import synthetic_cifar, _make_split
    from rcgan_tpu.data.confusion import build_confusion
    from rcgan_tpu.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

    cfg = ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12, algorithm="rcgan",
                          normalization_g=False)
    tcfg = CifarTrainConfig(n_critic=2)
    c, _ = build_confusion(0.6, 10)
    tr = CifarTrainer(cfg, CifarAlgoConfig(algorithm="rcgan"), tcfg, c, mesh=None)

    b = 16
    ts = tr.init(jax.random.key(0), b)
    x, y = synthetic_cifar(64, seed=3)
    split = _make_split(x, y, alpha=0.6, seed=4)
    imgs, labels, labels_random, labels_biased, inv_w = next(split.epoch(b))

    def rep(a):
        a = np.asarray(a)
        return jnp.asarray(np.broadcast_to(a, (tcfg.n_critic,) + a.shape).copy())

    d_batches = {
        "images": rep(imgs.astype(np.int32)),
        "labels": rep(labels),
        "labels_random": rep(labels_random),
        "labels_biased": rep(labels_biased),
        "labels_inv_weights": rep(inv_w.astype(np.float32)),
    }
    g_full = jnp.asarray(np.concatenate([labels_random, labels_random]))
    g_labels = {"random": g_full, "biased": g_full}

    ts, m1 = tr.step(ts, d_batches, g_labels, 1, jax.random.key(5))
    ts, m2 = tr.step(ts, d_batches, g_labels, 2, jax.random.key(6))
    expect = (float(m1["d_cost"]), float(m1["g_cost"]), float(m2["d_cost"]))
    np.testing.assert_allclose(results[0], expect, rtol=1e-4, atol=1e-5)
