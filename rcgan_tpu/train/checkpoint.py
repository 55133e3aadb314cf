"""Checkpoint/resume (reference: ``tf.train.Saver`` —
``mnist/model.py:836-867``; ``cifar10/gan_resnet.py:905-914`` with
``max_to_keep=5`` and latest-checkpoint auto-resume).

The full :class:`TrainState` is captured — params, confusion logits, BN
moving stats, SN ``u`` vectors, and all optimizer slots — matching the
reference's Saver-saves-all-variables behavior (SURVEY §5.4).  Also provides
``optimistic_restore``-style partial loading (``common/misc.py:275-307``).

Format: ``<dir>/<step>/state.npz``, one array per pytree leaf keyed by its
path (``groups/gen/G.Input/W``).  A step directory appears only once its file
is complete (written under a temporary name, then renamed).  Restores put
each leaf on the device, or into a requested sharding, so a state saved from
one mesh layout restores onto any other.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import jax
import numpy as np

from rcgan_tpu.train.state import TrainState

_FILE = "state.npz"


def _payload(ts: TrainState) -> dict:
    return {"groups": ts.groups, "state": ts.state, "opt_states": ts.opt_states, "step": ts.step}


def _key(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator="/")


def _as_leaf(arr: np.ndarray, like) -> np.ndarray:
    """``arr`` in the template leaf's dtype.  ``np.savez`` stores dtypes it
    does not know (bfloat16) as raw bytes; those are viewed back."""
    dtype = like.dtype if hasattr(like, "dtype") else np.asarray(like).dtype
    if arr.dtype.kind == "V":
        return arr.view(dtype)
    return arr.astype(dtype, copy=False)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, ts: TrainState, wait: bool = False):
        """Copy the state to the host now, write it in the background (the
        reference saves EVERY iteration for the first 500,
        ``gan_resnet.py:1007``).  One write is in flight at a time;
        ``wait=True`` or :meth:`close` finalizes."""
        self.close()
        leaves = jax.tree_util.tree_flatten_with_path(_payload(ts))[0]
        arrays = {_key(path): np.asarray(leaf) for path, leaf in leaves}
        self._writer = threading.Thread(target=self._write, args=(int(step), arrays))
        self._writer.start()
        if wait:
            self.close()

    def _write(self, step: int, arrays: dict):
        try:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, _FILE), **arrays)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self._steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # re-raised on the caller's thread by close()
            self._error = e

    def close(self):
        """Wait for the write in flight; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def latest_step(self) -> Optional[int]:
        self.close()
        steps = self._steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]) -> Optional[dict]:
        self.close()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with np.load(os.path.join(self.directory, str(step), _FILE)) as f:
            return {k: f[k] for k in f.files}

    def restore_sharded(
        self,
        ts_template: TrainState,
        shardings: Optional[TrainState],
        step: Optional[int] = None,
    ) -> Optional[TrainState]:
        """Restore a (possibly GSPMD-sharded) checkpoint directly onto a
        device mesh: each leaf is placed with the requested ``Sharding``,
        so a state saved from one mesh shape restores onto any other.
        ``shardings``: a TrainState-shaped tree of ``jax.sharding.Sharding``
        (see ``parallel.gspmd.train_state_shardings``), or None for the
        default device."""
        arrays = self._load(step)
        if arrays is None:
            return None
        paths, treedef = jax.tree_util.tree_flatten_with_path(_payload(ts_template))
        if shardings is None:
            placements = [None] * len(paths)
        else:
            placements = treedef.flatten_up_to(_payload(shardings))
        leaves = [jax.device_put(_as_leaf(arrays[_key(p)], leaf), sh)
                  for (p, leaf), sh in zip(paths, placements)]
        return TrainState(**jax.tree_util.tree_unflatten(treedef, leaves))

    def restore(self, ts_template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Restore into the template's structure on the default device;
        None when no checkpoint."""
        return self.restore_sharded(ts_template, None, step)


def optimistic_restore(ts_template: TrainState, directory: str) -> tuple:
    """Shape-tolerant partial restore: copies only leaves whose path+shape
    match the template (the ``optimistic_restore`` capability,
    ``cifar10/common/misc.py:275-307``).  Returns (state, n_loaded)."""
    arrays = Checkpointer(directory)._load(None)
    paths, treedef = jax.tree_util.tree_flatten_with_path(_payload(ts_template))
    if arrays is None:
        return ts_template, 0
    leaves, loaded = [], 0
    for path, leaf in paths:
        new = arrays.get(_key(path))
        if new is not None and new.shape == np.shape(leaf):
            leaves.append(jax.numpy.asarray(_as_leaf(new, leaf)))
            loaded += 1
        else:
            leaves.append(leaf)
    return TrainState(**jax.tree_util.tree_unflatten(treedef, leaves)), loaded
