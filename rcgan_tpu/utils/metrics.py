"""Scalar metric recording for training runs.

Covers the capability surface of the reference's ``lib.plot`` logging
channel (``cifar10/common/plot.py``): record named scalars against an
iteration counter, periodically emit a one-line window summary to the log,
and persist the full history to disk.  Curves are drawn from that history
(``log.pkl`` / ``metrics.jsonl``) by offline tooling, not during training.

Design (original, columnar): each metric is an append-only pair of arrays
``(steps, values)``; a per-metric watermark tracks how much of the series
has already been summarized, so a flush is "summarize the tail past the
watermark" rather than a copy between dicts.  History is persisted both as
``log.pkl`` (``{name: {step: value}}``, the layout downstream plotting
scripts expect) and as machine-readable ``metrics.jsonl`` lines.
"""

from __future__ import annotations

import json
import logging
import os
import pickle

import numpy as np

log = logging.getLogger(__name__)


class _Series:
    __slots__ = ("steps", "values", "watermark")

    def __init__(self):
        self.steps: list[int] = []
        self.values: list[float] = []
        self.watermark = 0  # prefix length already summarized by a flush

    def append(self, step: int, value: float):
        self.steps.append(step)
        self.values.append(value)

    def window(self):
        """Values recorded since the last flush."""
        return self.values[self.watermark:]

    def advance(self):
        self.watermark = len(self.values)


class MetricLogger:
    """Step-indexed scalar recorder with windowed flushes.

    ``plot`` records at the current step, ``plot_at`` at an explicit step
    (device-buffered metrics arrive in blocks), ``tick`` advances the step
    counter, and ``dir_flush`` summarizes + persists.
    """

    def __init__(self):
        self._series: dict[str, _Series] = {}
        self._step = 0

    @property
    def step(self) -> int:
        return self._step

    def tick(self):
        self._step += 1

    def plot(self, name: str, value):
        self.plot_at(name, value, self._step)

    def plot_at(self, name: str, value, step: int):
        self._series.setdefault(name, _Series()).append(int(step), float(value))

    def latest(self, name: str):
        s = self._series.get(name)
        if s is None or not s.values:
            return None
        return s.values[-1]

    def history(self, name: str):
        """Full (steps, values) arrays for one metric."""
        s = self._series[name]
        return np.asarray(s.steps), np.asarray(s.values)

    def dir_flush(self, out_dir: str, log_pkl: bool = True):
        """Summarize the unflushed tail of every metric.

        Emits one log line of per-metric window means and persists history.
        Returns the summary strings.
        """
        parts = []
        for name, series in self._series.items():
            tail = series.window()
            if not tail:
                continue
            parts.append(f"{name}: {np.mean(tail):.6g}")
            series.advance()
        log.info("iter %d\n%s", self._step, ", ".join(parts))
        if log_pkl:
            self._persist(out_dir)
        return parts

    def _persist(self, out_dir: str):
        # log.pkl keeps the {name: {step: value}} layout for plot tooling.
        snapshot = {
            name: dict(zip(s.steps, s.values)) for name, s in self._series.items()
        }
        with open(os.path.join(out_dir, "log.pkl"), "wb") as f:
            pickle.dump(snapshot, f, pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(out_dir, "metrics.jsonl"), "w") as f:
            for name, s in self._series.items():
                f.write(json.dumps({"name": name, "steps": s.steps,
                                    "values": s.values}) + "\n")
