"""Eval classifiers replacing the reference's frozen GraphDefs.

The reference scores generated images with two frozen TF graphs:
``mnist/mnist_dcnn/graph_optimized.pb`` (missing from the repo — listed in
``.MISSING_LARGE_BLOBS``) and ``cifar10/resnet-110/graph_optimized.pb``
(``mnist/utils.py:273-306``, ``cifar10/gan_resnet.py:424-455``).  The rebuild
must own these hooks, so we define compact jit-compiled classifiers (a
CNN for MNIST, a ResNet for CIFAR) plus a trainer; weights are trained once
on clean labels and cached to disk.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Callable, Tuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops import conv2d_lib, linear_lib, mean_pool


def mnist_cnn(ctx: Ctx, x: jax.Array) -> jax.Array:
    """Small conv net standing in for the missing ``mnist_dcnn`` frozen
    graph: conv-pool x2 + 2 dense.  ``x``: [B, 28, 28, 1] in [0, 1]."""
    h = conv2d_lib(ctx, x, 1, 32, 5, 1, "cls.conv1")
    h = jax.nn.relu(h)
    h = mean_pool(h)
    h = conv2d_lib(ctx, h, 32, 64, 5, 1, "cls.conv2")
    h = jax.nn.relu(h)
    h = mean_pool(h)
    h = h.reshape(h.shape[0], -1)
    h = jax.nn.relu(linear_lib(ctx, h, 7 * 7 * 64, 256, "cls.fc1"))
    return linear_lib(ctx, h, 256, 10, "cls.fc2")


def cifar_resnet(ctx: Ctx, x: jax.Array, dim: int = 64) -> jax.Array:
    """Compact pre-act ResNet standing in for the frozen ResNet-110 scorer.
    ``x``: [B, 32, 32, 3] in [-1, 1]."""

    def block(h, cin, cout, name, down=False):
        sc = h
        if down or cin != cout:
            sc = conv2d_lib(ctx, mean_pool(h) if down else h, cin, cout, 1, 1, name + ".sc",
                            he_init=False)
        o = jax.nn.relu(h)
        o = conv2d_lib(ctx, o, cin, cout, 3, 1, name + ".c1")
        o = jax.nn.relu(o)
        o = conv2d_lib(ctx, o, cout, cout, 3, 1, name + ".c2")
        if down:
            o = mean_pool(o)
        return sc + o

    h = conv2d_lib(ctx, x, 3, dim, 3, 1, "cls.stem")
    h = block(h, dim, dim, "cls.b1")
    h = block(h, dim, dim * 2, "cls.b2", down=True)
    h = block(h, dim * 2, dim * 2, "cls.b3")
    h = block(h, dim * 2, dim * 4, "cls.b4", down=True)
    h = block(h, dim * 4, dim * 4, "cls.b5")
    h = jax.nn.relu(h)
    h = jnp.mean(h, axis=(1, 2))
    return linear_lib(ctx, h, dim * 4, 10, "cls.head")


class EvalClassifier:
    """init/train/predict wrapper around one of the nets above."""

    def __init__(self, net: Callable, input_shape: Tuple[int, ...]):
        self.net = net
        self.input_shape = input_shape
        self.params = None
        self.meta: dict = {}

    def init(self, rng: jax.Array):
        ctx = Ctx(rng=rng, init=True)
        self.net(ctx, jnp.zeros((2,) + self.input_shape, jnp.float32))
        self.params = ctx.params
        return self.params

    @functools.partial(jax.jit, static_argnums=0)
    def logits(self, params, x):
        ctx = Ctx(params=params, state={}, init=False)
        return self.net(ctx, x)

    def predict(self, x: np.ndarray, batch_size: int = 500) -> np.ndarray:
        # dispatch every batch async, concatenate ON DEVICE, fetch once — a
        # per-batch np.asarray would be one device->host sync each
        outs = []
        for i in range(0, len(x), batch_size):
            outs.append(jnp.argmax(self.logits(self.params, x[i : i + batch_size]), -1))
        return np.asarray(outs[0] if len(outs) == 1 else jnp.concatenate(outs))

    def train(
        self,
        rng: jax.Array,
        x: np.ndarray,
        y: np.ndarray,
        epochs: int = 3,
        batch_size: int = 256,
        lr: float = 1e-3,
    ) -> float:
        """Adam + softmax CE on clean labels; returns final train accuracy."""
        if self.params is None:
            self.init(rng)
        opt = optax.adam(lr)
        opt_state = opt.init(self.params)

        @jax.jit
        def step(params, opt_state, xb, yb):
            def loss_fn(p):
                ctx = Ctx(params=p, state={}, init=False)
                logits = self.net(ctx, xb)
                return jnp.mean(
                    optax.softmax_cross_entropy_with_integer_labels(logits, yb)
                ), logits

            (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            acc = jnp.mean(jnp.argmax(logits, -1) == yb)
            return params, opt_state, loss, acc

        n = len(x)
        acc = 0.0
        rs = np.random.RandomState(0)
        for _ in range(epochs):
            perm = rs.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = perm[i : i + batch_size]
                self.params, opt_state, loss, acc = step(
                    self.params, opt_state, jnp.asarray(x[idx]), jnp.asarray(y[idx])
                )
        return float(acc)

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        """Top-1 accuracy on (clean) data — the classifier's yardstick."""
        return float((self.predict(x) == np.asarray(y)).mean())

    # ------------------------------------------------------- persistence
    def save(self, path: str, meta: dict | None = None):
        if meta is not None:
            self.meta = dict(meta)
        with open(path, "wb") as f:
            pickle.dump(
                {"params": jax.tree_util.tree_map(np.asarray, self.params),
                 "meta": self.meta},
                f,
            )

    def load(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict) and "params" in blob and "meta" in blob:
            self.params, self.meta = blob["params"], blob["meta"]
        else:  # legacy cache: raw param tree, no pin
            self.params, self.meta = blob, {}
        return True


# A cached classifier may regress (stale cache, changed data regime); the
# gen-label-acc yardstick is only meaningful when the scorer itself is good,
# so loading fails loudly when re-measured clean accuracy drops below the
# pinned value by more than this.
PIN_TOLERANCE = 0.02


def train_pinned(
    cls: EvalClassifier,
    path: str,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    epochs: int = 5,
    rng: jax.Array | None = None,
    max_val: int = 5000,
) -> float:
    """Load-or-train an eval classifier with a PINNED clean-data accuracy.

    The reference pins its scorers as frozen graphs (ResNet-110
    ``cifar10/gan_resnet.py:424-455``; mnist_dcnn ``mnist/utils.py:273-306``)
    so every gen-label-acc number has a fixed yardstick.  Here the pin is
    the classifier's measured accuracy on held-out CLEAN data, stored with
    the weights; a cached classifier that re-scores below its pin raises.

    Returns the clean accuracy (the number QUALITY.md rows must cite).
    """
    xv, yv = x_val[:max_val], y_val[:max_val]
    if cls.load(path):
        pinned = cls.meta.get("clean_accuracy")
        if pinned is not None:
            acc = cls.accuracy(xv, yv)
            if acc < pinned - PIN_TOLERANCE:
                raise RuntimeError(
                    f"cached eval classifier {path} scores {acc:.4f} on clean "
                    f"data, below its pin {pinned:.4f} (tol {PIN_TOLERANCE}); "
                    "delete the cache to retrain"
                )
            return acc
        # legacy cache without a pin: fall through and retrain to create one

    cls.train(rng if rng is not None else jax.random.key(123), x_train, y_train, epochs=epochs)
    acc = cls.accuracy(xv, yv)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cls.save(path, meta={"clean_accuracy": acc, "version": 2, "epochs": epochs,
                         "n_train": int(len(x_train))})
    return acc


def mnist_classifier() -> EvalClassifier:
    return EvalClassifier(mnist_cnn, (28, 28, 1))


def cifar_classifier(dim: int = 64, img_size: int = 32) -> EvalClassifier:
    """``img_size``: the net is fully convolutional (global mean pool), so
    any resolution works — 64 is used for the PGGAN 64x64 stage evals."""
    return EvalClassifier(functools.partial(cifar_resnet, dim=dim),
                          (img_size, img_size, 3))


def generated_label_accuracy(
    classifier: EvalClassifier,
    samples: np.ndarray,
    labels: np.ndarray,
    confusion_matrix: np.ndarray | None = None,
) -> float:
    """Generator-label accuracy (``cifar10/gan_resnet.py:424-455``;
    ``mnist/utils.py:273-306``): fraction of generated images the eval
    classifier assigns to their conditioning label.

    ``confusion_matrix``: the learned C for the permutation-corrected
    variant (``--perm_gen_label_acc``): labels are first mapped through the
    argmax-binarized C.
    """
    if confusion_matrix is not None:
        perm = np.argmax(confusion_matrix, axis=-1)
        labels = perm[labels]
    preds = classifier.predict(samples)
    return float((preds == labels).mean())
