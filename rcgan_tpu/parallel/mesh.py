"""Device-mesh + sharding helpers — the SPMD replacement for the
reference's 2-GPU in-graph tower replication (SURVEY §2.4).

Scaling axes:
  * ``data`` — batch sharding; gradients ``psum`` inside shard_map.
  * ``model`` — optional tensor-parallel axis for the generator's wide input
    projection and the discriminator's output head (the only layers big
    enough to benefit at CIFAR scale); exposed for the multi-chip dry run.

Multi-host: call :func:`maybe_initialize_distributed` first; the same SPMD
program then spans hosts over DCN with per-host data feeding
(``CifarSplit.epoch(shard=(host, n_hosts))``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D ``('data',)`` mesh by default; 2-D ``('data','model')`` when
    ``n_model > 1``."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    devs = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    if n_model == 1:
        return Mesh(devs.reshape(-1), ("data",))
    return Mesh(devs, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place a host batch onto the mesh, sharded along the leading axis."""
    sh = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def replicate(mesh: Mesh, tree):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def maybe_initialize_distributed():
    """Multi-host bootstrap (no-op single-process): JAX distributed init,
    after which the same pjit/shard_map program spans all hosts.

    Cluster topology comes from the launcher: Slurm / OMPI are
    auto-detected by JAX; manual launches (and the 2-process CPU harness
    test) set ``JAX_COORDINATOR_ADDRESS`` + ``JAX_NUM_PROCESSES`` +
    ``JAX_PROCESS_ID``."""
    import os

    if "JAX_COORDINATOR_ADDRESS" in os.environ:
        kwargs = {}
        if "JAX_NUM_PROCESSES" in os.environ:
            kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
        if "JAX_PROCESS_ID" in os.environ:
            kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(**kwargs)


def param_shardings(mesh: Mesh, params, rules: Optional[dict] = None):
    """Per-leaf NamedShardings.  ``rules`` maps layer-name predicates to
    PartitionSpecs for tensor-parallel layouts; default fully replicated.

    Example TP rule for the CIFAR generator's 128 → 16384 input projection:
    ``{lambda n: n == 'G.Input': P(None, 'model')}`` shards the output
    features so the matmul runs column-parallel with no collective until the
    next layer's all-gather.
    """
    rules = rules or {}

    def leaf_spec(layer, name, x):
        for pred, spec in rules.items():
            if pred(layer) and np.ndim(x) >= len([s for s in spec if s is not None]):
                return NamedSharding(mesh, spec)
        return NamedSharding(mesh, P())

    return {
        layer: {name: leaf_spec(layer, name, x) for name, x in d.items()}
        for layer, d in params.items()
    }
