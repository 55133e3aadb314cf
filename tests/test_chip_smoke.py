"""The device-facing tooling on the CPU: chip_smoke.py's option parsing,
result line and refusals, the benchmark's refusal without a GPU, the entry
points' hands-off platform handling, the compile-cache rule, the peak table,
the trace reduction, and the checkpoint format.  ``test_chip_smoke_on_card``
is the one test that needs the card; it skips here."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, env_extra=None, cwd=REPO, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=timeout)


@pytest.mark.parametrize("argv,chips", [([], 1), (["--chips", "1"], 1), (["--chips", "4"], 4)])
def test_chip_smoke_chips_option(argv, chips):
    assert chip_smoke.parse_args(argv).chips == chips


def test_chip_smoke_rejects_other_chip_counts():
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--chips", "2"])


def test_chip_smoke_last_line():
    line = chip_smoke.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                 "count": 4, "extra": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_refuses_cpu_platform():
    out = _run([os.path.join(REPO, "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "needs a GPU" in out.stderr + out.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_without_gpu():
    out = _run([os.path.join(REPO, "bench.py")])
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "needs a GPU" in out.stderr


@pytest.fixture
def card():
    """Decides here, not at import, whether a GPU exists."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU; runs on the card via `python chip_smoke.py`")
    return smi


@pytest.mark.chip
def test_chip_smoke_on_card(card):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["device"]["platform"] == "gpu"


def test_entry_leaves_jax_platforms_untouched(monkeypatch):
    import __graft_entry__
    from rcgan_tpu.models import resnet_gan

    tiny = resnet_gan.ResnetGANConfig
    monkeypatch.setattr(resnet_gan, "ResnetGANConfig",
                        lambda: tiny(dim_g=8, dim_d=8, embedding_dim=12))
    before = jax.config.jax_platforms
    fwd, args = __graft_entry__.entry()
    out = jax.jit(fwd)(*args)
    assert jax.config.jax_platforms == before
    assert out.shape == (64,) and np.isfinite(np.asarray(out, np.float32)).all()


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        __graft_entry__._require_devices(16)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from rcgan_tpu.utils import compilation_cache
d = compilation_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(3)).block_until_ready()
print(d, jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory_rule(env_set, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and the code
    sets no directory; without it, in the checkout's fixed .jax_cache."""
    from rcgan_tpu.utils.compilation_cache import DEFAULT_DIR

    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    salt = float(np.random.RandomState().randint(1, 10**6))
    env = {"PYTHONPATH": REPO}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    out = _run(["-c", _CACHE_PROBE.format(salt=salt)], env_extra=env)
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path / "cc") if env_set else DEFAULT_DIR
    assert out.stdout.split() == [want, want]
    assert os.listdir(want)


def test_peak_table_is_keyed_by_device_kind():
    from rcgan_tpu.utils.profiling import peaks

    assert peaks("NVIDIA H100 80GB HBM3") == {"bf16_tflops": 989.0, "hbm_tbps": 3.35}
    with pytest.raises(KeyError, match="no published peak"):
        peaks("cpu")


def test_trace_reduction_attributes_kernels_to_named_scopes(tmp_path):
    from rcgan_tpu.utils.profiling import (attribute, busy_ns, device_events, hlo_scopes,
                                           latest_xplane, trace)

    def f(x, w):
        with jax.named_scope("conv"):
            y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
        with jax.named_scope("cond_bn"):
            y = jnp.tanh(y - y.mean(axis=(0, 1, 2)))
        return y.sum()

    g = jax.jit(jax.grad(f, argnums=(0, 1)))
    x, w = jnp.ones((2, 8, 8, 16)), jnp.ones((3, 3, 16, 16))
    jax.block_until_ready(g(x, w))
    with trace(str(tmp_path)):
        jax.block_until_ready(g(x, w))
    events = device_events(latest_xplane(str(tmp_path)), "/host:CPU")
    assert events and all(e["hlo_module"].startswith("jit_") for e in events)
    scopes_of = hlo_scopes(g.lower(x, w).compile().as_text(), ("conv", "cond_bn", "sn"))
    by = attribute(events, scopes_of)
    assert by.get("conv", 0) > 0 and by.get("cond_bn", 0) > 0 and "sn" not in by
    assert sum(by.values()) == pytest.approx(sum(e["dur_ns"] for e in events))
    assert 0 < busy_ns(events) <= sum(e["dur_ns"] for e in events)


def test_busy_time_is_the_union_of_intervals():
    from rcgan_tpu.utils.profiling import busy_ns

    ev = [{"start_ns": s, "dur_ns": d} for s, d in ((0, 10), (5, 10), (30, 5), (31, 1))]
    assert busy_ns(ev) == 20


def test_checkpoint_round_trips_bf16_and_keeps_five(tmp_path):
    from rcgan_tpu.train.checkpoint import Checkpointer, optimistic_restore
    from rcgan_tpu.train.state import TrainState

    ts = TrainState(groups={"g": {"l": {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}}},
                    state={"s": {"u": jnp.ones((1, 3))}}, opt_states={}, step=jnp.asarray(3))
    ck = Checkpointer(str(tmp_path))
    for step in range(7):
        ck.save(step, ts)
    ck.close()
    assert sorted(os.listdir(tmp_path)) == [str(s) for s in range(2, 7)]
    back = ck.restore(ts)
    w = back.groups["g"]["l"]["w"]
    assert w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(w, np.float32), np.arange(6).reshape(2, 3))
    assert int(back.step) == 3
    _, n = optimistic_restore(ts, str(tmp_path))
    assert n == 3
