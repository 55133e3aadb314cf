"""Serving: load a trained checkpoint and generate class-conditional images
with pre-compiled samplers — the deployment surface the reference lacks
(its only inference path was re-running the training script with
``--notrain``).

Production hardening on top of the checkpoint-backed sampler:

- **Batch-size buckets**: samplers are compiled once per bucket size and
  ragged requests route to the smallest covering bucket (pad-and-slice),
  so a 3-image request does not pay a 100-image generator pass.
- **AOT export** (``jax.export``): the sampler (weights baked in) can be
  serialized to a StableHLO artifact and reloaded WITHOUT the framework,
  checkpoint, or retracing — process restarts skip compile entirely.
- **HTTP endpoint** (stdlib-only, threaded): ``GET /sample?labels=1,2,3&
  seed=0`` returns a PNG grid; ``GET /healthz`` for probes; ``GET /models``
  lists the registry; ``GET /metrics`` exposes Prometheus-style counters.
- **Cross-client request coalescing**: concurrent ``/sample`` requests are
  merged into ONE compiled device pass by a per-model :class:`Coalescer`
  worker — N simultaneous small requests cost one bucketed generator call,
  not N.  Each request's latent ``z`` is derived from its own seed before
  merging, so a request's images do not depend on who it was batched with
  (up to CIFAR's batch-statistics cond-BN, which is batch-dependent by
  reference semantics, ``normalization.py:47-58``).
- **Multi-model registry + auth**: serve several checkpoints from one
  process (``--register name=model:ckpt_dir``), optional bearer-token auth.

CLI:  python -m rcgan_tpu.serving --model {mnist,cifar,pggan} --checkpoint_dir D \
        [--labels 0,1,2 --n 100 --out grid.png] [--export path.bin]
        [--serve --port 8321] [--register name=model:dir ...] \
        [--auth_token TOK] [--coalesce_wait_ms 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import threading
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np

import jax
import jax.numpy as jnp

DEFAULT_BUCKETS = (1, 8, 32, 100)


def _load_run_config(checkpoint_dir: str) -> dict:
    """The apps archive every flag as ``config.json`` in the run dir
    (``utils/run_dir.py::record_setting``); the checkpoint lives one level
    below (``<run>/ckpt`` or ``<run>/checkpoint``).  Search the checkpoint
    dir and two ancestors so a Sampler pointed at any of them self-configures."""
    import json

    d = os.path.abspath(checkpoint_dir)
    for _ in range(3):
        path = os.path.join(d, "config.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        d = os.path.dirname(d)
    return {}


class Sampler:
    """Checkpoint-backed conditional sampler with bucketed compiled batch
    shapes (pad-and-slice for ragged requests)."""

    def __init__(self, trainer, ts, model: str, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 z_dim: int = 128):
        self.trainer = trainer
        self.ts = ts
        self.model = model
        self.buckets = tuple(sorted(buckets))
        self.z_dim = z_dim

    @classmethod
    def from_checkpoint(cls, model: str, checkpoint_dir: str,
                        buckets: Sequence[int] = DEFAULT_BUCKETS, **overrides):
        """Build the restore template ALGORITHM-AWARE: an RCGAN-U
        checkpoint carries confusion-matrix (and perm-classifier) state
        that a plain-rcgan template would not have at restore time.

        Config resolution, lowest to highest precedence: dataclass
        defaults < the run's archived ``config.json`` (auto-detected next
        to ``checkpoint_dir``) < explicit ``overrides`` (model-config
        fields like ``dim_g`` and algo fields like ``algorithm=`` /
        ``estimate_confuse=`` are routed to the right config by name).
        """
        import dataclasses

        from rcgan_tpu.data.confusion import one_coin_matrix
        from rcgan_tpu.train.checkpoint import Checkpointer

        run_cfg = dict(_load_run_config(checkpoint_dir))
        run_cfg.update(overrides)

        def pick(dc_type):
            fields = {f.name for f in dataclasses.fields(dc_type)}
            return {k: v for k, v in run_cfg.items() if k in fields}

        batch = max(buckets)
        if model == "cifar":
            from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
            from rcgan_tpu.models.resnet_gan import ResnetGANConfig
            from rcgan_tpu.train.cifar_loop import CifarTrainer, CifarTrainConfig

            mkw = pick(ResnetGANConfig)
            mkw.setdefault("algorithm", run_cfg.get("algorithm", "rcgan"))
            cfg = ResnetGANConfig(**mkw)
            akw = pick(CifarAlgoConfig)
            akw["algorithm"] = cfg.algorithm
            akw.setdefault("perm_classifier", bool(run_cfg.get("perm_classifier", False)))
            trainer = CifarTrainer(cfg, CifarAlgoConfig(**akw),
                                   CifarTrainConfig(), one_coin_matrix(0.6, 10))
            ts = trainer.init(jax.random.key(0), batch)
            z_dim = cfg.z_dim
        elif model == "mnist":
            from rcgan_tpu.algorithms.mnist import MnistAlgoConfig
            from rcgan_tpu.models.dcgan import DCGANConfig
            from rcgan_tpu.train.mnist_loop import MnistTrainer, MnistTrainConfig

            mkw = pick(DCGANConfig)
            if "concat_y_layers" in mkw:
                mkw["concat_y_layers"] = tuple(int(x) for x in mkw["concat_y_layers"])
            cfg = DCGANConfig(**mkw)
            akw = pick(MnistAlgoConfig)
            akw.setdefault("algorithm", run_cfg.get("algorithm", "rcgan"))
            # the MNIST CLI exposes perm_regularizer as --aux_classifier too
            if "aux_classifier" in run_cfg and run_cfg["aux_classifier"] is not None:
                akw.setdefault("perm_regularizer", bool(run_cfg["aux_classifier"]))
            trainer = MnistTrainer(cfg, MnistAlgoConfig(**akw),
                                   MnistTrainConfig(), one_coin_matrix(0.6, 10))
            dummy = {
                "images": jnp.zeros((batch, 28, 28, 1), jnp.float32),
                "y_real": jnp.zeros((batch,), jnp.int32),
                "y_gen": jnp.zeros((batch,), jnp.int32),
                "y_fake": jnp.zeros((batch,), jnp.int32),
                "y_real_weights": jnp.zeros((batch, 10), jnp.float32),
            }
            ts = trainer.init(jax.random.key(0), dummy)
            z_dim = cfg.z_dim
        elif model == "pggan":
            # progressive checkpoints come from pggan_app's phase-boundary
            # Checkpointer; the run's config.json names the schedule shape
            from rcgan_tpu.models.pggan import PGGANConfig
            from rcgan_tpu.models.resnet_gan import ResnetGANConfig
            from rcgan_tpu.train.pggan_loop import PGGANTrainConfig, PGGANTrainer

            cfg = PGGANConfig(**pick(PGGANConfig))
            base = ResnetGANConfig(dim_g=cfg.dim, dim_d=cfg.dim, z_dim=cfg.z_dim)
            trainer = PGGANTrainer(cfg, base, PGGANTrainConfig())
            ts = trainer.init(jax.random.key(0), batch)
            z_dim = cfg.z_dim
        else:
            raise ValueError(model)

        ckpt = Checkpointer(checkpoint_dir)
        restored = ckpt.restore(ts)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        return cls(trainer, restored, model, buckets, z_dim)

    # ----------------------------------------------------------- internals
    def draw_z(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Latents in the model's training prior (MNIST U[-1,1], CIFAR
        N(0,1)), drawn host-side so a request's z is a pure function of its
        own seed — the property coalescing relies on."""
        if self.model == "mnist":
            return rng.uniform(-1.0, 1.0, (n, self.z_dim)).astype(np.float32)
        return rng.standard_normal((n, self.z_dim)).astype(np.float32)

    def _run_batch_z(self, z: jax.Array, padded: np.ndarray) -> np.ndarray:
        """One compiled pass at len(padded) (a bucket size), explicit z."""
        if self.model == "mnist":
            y = jnp.eye(10, dtype=jnp.float32)[padded]
            return np.asarray(self.trainer.sample(self.ts, z, y))
        if self.model == "pggan":
            # already NHWC at the schedule's final resolution
            return np.asarray(self.trainer.sample(self.ts, z, jnp.asarray(padded)))
        flat = np.asarray(self.trainer.sample(self.ts, z, jnp.asarray(padded)))
        return flat.reshape(-1, 32, 32, 3)

    def _run_batch(self, padded: np.ndarray, key: jax.Array) -> np.ndarray:
        b = len(padded)
        if self.model == "mnist":
            z = jax.random.uniform(key, (b, self.z_dim), jnp.float32, -1.0, 1.0)
        else:
            z = jax.random.normal(key, (b, self.z_dim))
        return self._run_batch_z(z, padded)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def sample_with_z(self, z: np.ndarray, labels: Sequence[int]) -> np.ndarray:
        """Like :meth:`sample` but with caller-provided latents [N, z_dim]
        (the coalescer path).  Pads to the covering bucket with zero
        latents/label 0 and slices the pads back off."""
        labels = np.asarray(labels, np.int32)
        assert len(z) == len(labels), (len(z), len(labels))
        big = self.buckets[-1]
        outs = []
        i = 0
        while i < len(labels):
            chunk_l = labels[i : i + big]
            chunk_z = z[i : i + big]
            bucket = self._bucket_for(len(chunk_l))
            pad = bucket - len(chunk_l)
            if pad:
                chunk_l = np.concatenate([chunk_l, np.zeros(pad, np.int32)])
                chunk_z = np.concatenate(
                    [chunk_z, np.zeros((pad, self.z_dim), np.float32)])
            img = self._run_batch_z(jnp.asarray(chunk_z), chunk_l)
            outs.append(img[: bucket - pad])
            i += big
        return np.concatenate(outs)

    def sample(self, labels: Sequence[int], rng: Optional[jax.Array] = None) -> np.ndarray:
        """Generate one image per label; returns [N, H, W, C] float in the
        model's output range ([0,1] MNIST sigmoid / [-1,1] CIFAR tanh).
        Requests larger than the biggest bucket stream through it; the
        remainder routes to the smallest covering bucket."""
        rng = jax.random.key(0) if rng is None else rng
        labels = np.asarray(labels, np.int32)
        big = self.buckets[-1]
        outs = []
        i = 0
        while i < len(labels):
            chunk = labels[i : i + big]
            bucket = self._bucket_for(len(chunk))
            pad = bucket - len(chunk)
            padded = np.concatenate([chunk, np.zeros(pad, np.int32)]) if pad else chunk
            img = self._run_batch(padded, jax.random.fold_in(rng, i))
            outs.append(img[: len(chunk)])
            i += len(chunk)
        return np.concatenate(outs)

    # ---------------------------------------------------------- AOT export
    def export_sampler(self, path: str, bucket: Optional[int] = None):
        """Serialize the sampler at one bucket size to a ``jax.export``
        StableHLO artifact with the weights baked in.  The artifact is
        self-contained: reload with :func:`load_exported` — no framework
        model code, checkpoint, or retrace needed."""
        from jax import export as jexport

        b = bucket or self.buckets[-1]
        ts = self.ts

        if self.model == "mnist":
            def fn(z, labels):
                y = jnp.eye(10, dtype=jnp.float32)[labels]
                return self.trainer.sample(ts, z, y)
        elif self.model == "pggan":
            def fn(z, labels):
                return self.trainer.sample(ts, z, labels)
        else:
            def fn(z, labels):
                flat = self.trainer.sample(ts, z, labels)
                return flat.reshape(-1, 32, 32, 3)

        exp = jexport.export(jax.jit(fn))(
            jax.ShapeDtypeStruct((b, self.z_dim), jnp.float32),
            jax.ShapeDtypeStruct((b,), jnp.int32),
        )
        with open(path, "wb") as f:
            f.write(exp.serialize())
        return b


def load_exported(path: str):
    """Reload an exported sampler: returns ``fn(z [B, zdim] f32, labels [B]
    i32) -> images`` running the baked-in weights."""
    from jax import export as jexport

    with open(path, "rb") as f:
        exp = jexport.deserialize(f.read())
    return lambda z, labels: exp.call(jnp.asarray(z, jnp.float32), jnp.asarray(labels, jnp.int32))


# ------------------------------------------------------ metrics middleware
class ServingMetrics:
    """Thread-safe counters rendered in Prometheus text format at
    ``/metrics``.  Tracks per-model request counts/latency and the
    coalescer's batching efficiency (requests merged per device pass)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[str, int] = {}
        self._samples: Dict[str, int] = {}
        self._seconds: Dict[str, float] = {}
        self._errors: Dict[str, int] = {}
        self._batches = 0
        self._batched_requests = 0
        self._coalesced_batches = 0

    def observe_request(self, model: str, seconds: float, n_samples: int):
        with self._lock:
            self._requests[model] = self._requests.get(model, 0) + 1
            self._samples[model] = self._samples.get(model, 0) + n_samples
            self._seconds[model] = self._seconds.get(model, 0.0) + seconds

    def observe_error(self, model: str):
        with self._lock:
            self._errors[model] = self._errors.get(model, 0) + 1

    def observe_batch(self, n_requests: int):
        with self._lock:
            self._batches += 1
            self._batched_requests += n_requests
            if n_requests > 1:
                self._coalesced_batches += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": dict(self._requests),
                "samples": dict(self._samples),
                "errors": dict(self._errors),
                "batches_total": self._batches,
                "batched_requests_total": self._batched_requests,
                "coalesced_batches_total": self._coalesced_batches,
            }

    def render(self) -> str:
        s = self.snapshot()
        lines = [
            "# HELP rcgan_requests_total /sample requests served",
            "# TYPE rcgan_requests_total counter",
        ]
        for m, v in sorted(s["requests"].items()):
            lines.append(f'rcgan_requests_total{{model="{m}"}} {v}')
        lines += ["# TYPE rcgan_samples_total counter"]
        for m, v in sorted(s["samples"].items()):
            lines.append(f'rcgan_samples_total{{model="{m}"}} {v}')
        lines += ["# TYPE rcgan_request_seconds_sum counter"]
        with self._lock:
            for m, v in sorted(self._seconds.items()):
                lines.append(f'rcgan_request_seconds_sum{{model="{m}"}} {v:.6f}')
        lines += ["# TYPE rcgan_request_errors_total counter"]
        for m, v in sorted(s["errors"].items()):
            lines.append(f'rcgan_request_errors_total{{model="{m}"}} {v}')
        lines += [
            "# HELP rcgan_device_batches_total compiled generator passes",
            "# TYPE rcgan_device_batches_total counter",
            f"rcgan_device_batches_total {s['batches_total']}",
            "# HELP rcgan_batched_requests_total requests summed over passes",
            "# TYPE rcgan_batched_requests_total counter",
            f"rcgan_batched_requests_total {s['batched_requests_total']}",
            "# HELP rcgan_coalesced_batches_total passes that merged >1 request",
            "# TYPE rcgan_coalesced_batches_total counter",
            f"rcgan_coalesced_batches_total {s['coalesced_batches_total']}",
        ]
        return "\n".join(lines) + "\n"


# ------------------------------------------------------ request coalescing
@dataclasses.dataclass
class _Pending:
    labels: np.ndarray
    z: np.ndarray
    event: threading.Event
    out: Optional[np.ndarray] = None
    err: Optional[BaseException] = None


class Coalescer:
    """Cross-client batch coalescing: concurrent requests enqueue and a
    single worker thread drains the queue into ONE ``sample_with_z`` pass
    (which buckets/pads as usual), then scatters the outputs back.

    Per-request latents are drawn host-side from the request's own seed
    (:meth:`Sampler.draw_z`) BEFORE merging, so what a request gets does not
    depend on its batch-mates.  The worker waits ``max_wait_ms`` after the
    first enqueue to let concurrent requests pile in — bounded added latency
    for an N× cut in generator passes under concurrency.
    """

    def __init__(self, sampler: Sampler, max_wait_ms: float = 4.0,
                 metrics: Optional[ServingMetrics] = None):
        self.sampler = sampler
        self._wait_s = max_wait_ms / 1e3
        self.metrics = metrics
        self._cv = threading.Condition()
        self._queue: list = []
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, labels: Sequence[int], seed: int, timeout: float = 300.0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        labels = np.asarray(labels, np.int32)
        req = _Pending(labels=labels, z=self.sampler.draw_z(rng, len(labels)),
                       event=threading.Event())
        with self._cv:
            if self._stop:
                raise RuntimeError("coalescer closed")
            self._queue.append(req)
            self._cv.notify()
        if not req.event.wait(timeout):
            raise TimeoutError("sample request timed out")
        if req.err is not None:
            raise req.err
        return req.out

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(0.25)
                if self._stop and not self._queue:
                    return
            time.sleep(self._wait_s)  # gather window
            with self._cv:
                reqs, self._queue = self._queue, []
            if not reqs:
                continue
            try:
                z = np.concatenate([r.z for r in reqs])
                labels = np.concatenate([r.labels for r in reqs])
                imgs = self.sampler.sample_with_z(z, labels)
                i = 0
                for r in reqs:
                    r.out = imgs[i : i + len(r.labels)]
                    i += len(r.labels)
            except BaseException as e:  # noqa: BLE001 — scatter to callers
                for r in reqs:
                    r.err = e
            if self.metrics is not None:
                self.metrics.observe_batch(len(reqs))
            for r in reqs:
                r.event.set()


# ------------------------------------------------------------------ HTTP
# Request-size ceiling for the HTTP endpoint: a huge ?n= would block the
# device and exhaust memory.
MAX_REQUEST_SAMPLES = 1024


def to_unit_range(model: str, imgs: np.ndarray) -> np.ndarray:
    """Model output range → [0,1] for PNG encoding.  MNIST's sigmoid head
    already is; the CIFAR and PGGAN generators end in tanh ([-1,1]) —
    clipping them instead would zero the whole negative half."""
    if model in ("cifar", "pggan"):
        return (imgs + 1.0) / 2.0
    return imgs


def _to_png_grid(imgs: np.ndarray) -> bytes:
    from rcgan_tpu.utils.images import merge

    # ceil-sided grid padded with blank tiles so every requested image
    # appears (floor-sided truncation dropped up to 2*side images).
    n = len(imgs)
    side = max(1, int(np.ceil(np.sqrt(n))))
    if side * side > n:
        pad = np.zeros((side * side - n,) + imgs.shape[1:], imgs.dtype)
        imgs = np.concatenate([imgs, pad], axis=0)
    grid = merge(imgs, (side, side))
    if grid.ndim == 3 and grid.shape[-1] == 1:
        grid = grid[..., 0]
    from PIL import Image

    arr = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def make_server(models: Union[Sampler, Dict[str, Sampler]], port: int = 8321,
                host: str = "127.0.0.1", auth_token: Optional[str] = None,
                coalesce_wait_ms: float = 4.0,
                metrics: Optional[ServingMetrics] = None):
    """Threaded stdlib HTTP server over a model registry.

    - ``GET /healthz`` — liveness (never auth-gated).
    - ``GET /models`` — JSON list of registered model names.
    - ``GET /metrics`` — Prometheus text (request/sample/latency counters +
      coalescer batching stats).
    - ``GET /sample?labels=1,2,3&seed=0[&model=name]`` (or ``?n=16``) —
      PNG grid.  Concurrent requests to the same model are coalesced into
      one device pass (see :class:`Coalescer`).
    - ``auth_token``: if set, every endpoint but ``/healthz`` requires
      ``Authorization: Bearer <token>`` (or ``?token=``).

    ``models`` may be a single :class:`Sampler` (registered as
    ``"default"``) or a name→Sampler dict.  The returned server exposes
    ``.metrics`` and ``.coalescers`` and shuts the workers down on
    ``server_close()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    registry = {"default": models} if isinstance(models, Sampler) else dict(models)
    if not registry:
        raise ValueError("empty model registry")
    default_name = "default" if "default" in registry else sorted(registry)[0]
    mx = metrics if metrics is not None else ServingMetrics()
    coalescers = {
        name: Coalescer(s, max_wait_ms=coalesce_wait_ms, metrics=mx)
        for name, s in registry.items()
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self, q) -> bool:
            if auth_token is None:
                return True
            header = self.headers.get("Authorization", "")
            if header == f"Bearer {auth_token}":
                return True
            return q.get("token", [None])[0] == auth_token

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/healthz":
                return self._send(200, b"ok")
            if not self._authorized(q):
                return self._send(401, b"unauthorized")
            if url.path == "/models":
                body = json.dumps(sorted(registry)).encode()
                return self._send(200, body, "application/json")
            if url.path == "/metrics":
                return self._send(200, mx.render().encode(),
                                  "text/plain; version=0.0.4")
            if url.path != "/sample":
                return self._send(404, b"not found")
            name = q.get("model", [default_name])[0]
            if name not in registry:
                return self._send(404, b"unknown model %s" % name.encode())
            try:
                if "labels" in q:
                    labels = [int(x) for x in q["labels"][0].split(",")]
                else:
                    n = int(q.get("n", ["16"])[0])
                    if not 1 <= n <= MAX_REQUEST_SAMPLES:
                        return self._send(
                            400, b"n out of range (1..%d)" % MAX_REQUEST_SAMPLES)
                    labels = list(np.arange(n) % 10)
                seed = int(q.get("seed", ["0"])[0])
            except ValueError:
                return self._send(400, b"bad labels/seed")
            if len(labels) > MAX_REQUEST_SAMPLES:
                return self._send(
                    400, b"too many samples requested (max %d)" % MAX_REQUEST_SAMPLES)
            t0 = time.perf_counter()
            try:
                imgs = coalescers[name].submit(labels, seed)
            except Exception:  # noqa: BLE001
                mx.observe_error(name)
                return self._send(500, b"sampling failed")
            mx.observe_request(name, time.perf_counter() - t0, len(labels))
            imgs = to_unit_range(registry[name].model, imgs)
            return self._send(200, _to_png_grid(imgs), "image/png")

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def server_close(self):
            for c in coalescers.values():
                c.close()
            super().server_close()

    srv = Server((host, port), Handler)
    srv.metrics = mx
    srv.coalescers = coalescers
    return srv


def main(argv=None):
    from rcgan_tpu.utils.images import save_images

    p = argparse.ArgumentParser(description="rcgan_tpu sampler")
    p.add_argument("--model", choices=["mnist", "cifar", "pggan"], required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--labels", default=None, help="comma-separated class ids")
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export", default=None, help="write an AOT jax.export artifact here")
    p.add_argument("--serve", action="store_true", help="run the HTTP endpoint")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--algorithm", default=None,
                   help="override the checkpoint's training algorithm (usually "
                        "auto-detected from the run's config.json)")
    p.add_argument("--register", action="append", default=[],
                   metavar="NAME=MODEL:CKPT_DIR",
                   help="register extra models on the HTTP registry "
                        "(repeatable), e.g. --register mnist_u=mnist:./run2/ckpt")
    p.add_argument("--auth_token", default=None,
                   help="require Authorization: Bearer <token> on every "
                        "endpoint except /healthz")
    p.add_argument("--coalesce_wait_ms", type=float, default=4.0,
                   help="gather window for cross-client request coalescing")
    args = p.parse_args(argv)

    overrides = {} if args.algorithm is None else {"algorithm": args.algorithm}
    sampler = Sampler.from_checkpoint(args.model, args.checkpoint_dir, **overrides)

    if args.export:
        b = sampler.export_sampler(args.export)
        print(f"exported bucket-{b} sampler to {args.export}")
        return

    if args.serve:
        registry = {"default": sampler}
        for spec in args.register:
            try:
                name, rest = spec.split("=", 1)
                kind, ckpt = rest.split(":", 1)
            except ValueError:
                raise SystemExit(f"bad --register spec {spec!r} "
                                 "(want NAME=MODEL:CKPT_DIR)")
            registry[name] = Sampler.from_checkpoint(kind, ckpt)
        srv = make_server(registry, args.port, auth_token=args.auth_token,
                          coalesce_wait_ms=args.coalesce_wait_ms)
        print(f"serving {sorted(registry)} on http://127.0.0.1:{args.port} "
              "(/healthz, /models, /metrics, /sample)")
        srv.serve_forever()
        return

    if args.labels:
        labels = [int(x) for x in args.labels.split(",")]
    else:
        labels = list(np.arange(args.n) % 10)
    imgs = sampler.sample(labels, jax.random.key(args.seed))
    imgs = to_unit_range(args.model, imgs)
    n = len(imgs)
    side = int(np.floor(np.sqrt(n)))
    save_images(imgs[: side * side], (side, side), args.out)
    print(f"wrote {args.out} ({side}x{side} grid)")


if __name__ == "__main__":
    main()
