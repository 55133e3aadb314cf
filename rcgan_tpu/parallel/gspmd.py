"""GSPMD partitioning: jit with sharding annotations over a 2-D
``('data', 'model')`` mesh, letting XLA insert the collectives.

This is the compiler-driven alternative to the explicit shard_map path in
the trainers: batch inputs are sharded on ``data``; the parameter tree is
replicated except for the layers wide enough to benefit from tensor
parallelism, which are sharded on ``model``:

  * ``G.Input`` (z→4·4·8·dim_g, the widest matmul) — column-parallel W,
    output features sharded; XLA all-gathers before the first conv.
  * ``D.Output`` / projection embeddings — row-parallel.

The scaling-book recipe: pick a mesh, annotate shardings, let XLA insert
collectives over the device interconnect (NVLink between H100s).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DEFAULT_TP_RULES = {
    "G.Input": {"W": P(None, "model"), "b": P("model")},
    "D.Output": {"W": P("model", None)},
    "D.Embedding_y": {"W": P(None, "model"), "b": P("model")},
}


def make_dp_tp_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    assert len(devices) >= n_data * n_model
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def train_state_shardings(mesh: Mesh, ts, rules: Optional[Dict] = None):
    """NamedSharding tree matching a TrainState: params sharded per ``rules``
    (layer → {var: PartitionSpec}), everything else replicated."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    repl = NamedSharding(mesh, P())

    def param_leaf(layer):
        def inner(name, x):
            spec = rules.get(layer, {}).get(name)
            if spec is None or np.ndim(x) < len([s for s in spec if s is not None]):
                return repl
            return NamedSharding(mesh, spec)

        return inner

    groups = {
        g: {layer: {n: param_leaf(layer)(n, x) for n, x in d.items()} for layer, d in grp.items()}
        for g, grp in ts.groups.items()
    }
    state = jax.tree_util.tree_map(lambda x: repl, ts.state)
    # Optimizer slots replicated: Adam mu/nu of the tensor-sharded layers
    # could mirror the param sharding, but at this model scale the memory
    # win is negligible and replication keeps resharding out of the update.
    opt_states = jax.tree_util.tree_map(lambda x: repl, ts.opt_states)

    from rcgan_tpu.train.state import TrainState

    return TrainState(groups=groups, state=state, opt_states=opt_states, step=repl)


def apply_shardings(ts, shardings):
    """device_put the train state onto the mesh per the sharding tree."""
    return jax.tree_util.tree_map(jax.device_put, ts, shardings)


def gspmd_cycle(trainer, mesh: Mesh, rules: Optional[Dict] = None) -> Callable:
    """Build a pjit'd training cycle for a CifarTrainer over a dp×tp mesh.

    Returns ``step(ts, d_batches, g_labels, iteration, rng)``.  Inputs are
    constrained: batch leaves → P(None, 'data') / P('data'); the TrainState →
    the TP sharding tree.  Gradient reductions over 'data' and the TP
    collectives over 'model' are inserted by XLA.
    """
    repl = NamedSharding(mesh, P())
    data2 = NamedSharding(mesh, P(None, "data"))
    data1 = NamedSharding(mesh, P("data"))

    def body(ts, d_batches, g_labels, iteration, rng):
        d_batches = {k: jax.lax.with_sharding_constraint(v, data2) for k, v in d_batches.items()}
        g_labels = {k: jax.lax.with_sharding_constraint(v, data1) for k, v in g_labels.items()}
        # axis=None: the pure single-program body; GSPMD partitions it.
        return trainer._cycle(ts, d_batches, g_labels, iteration, rng, axis=None)

    return jax.jit(body, donate_argnums=0)
