"""Profiling hooks and the device facts every measurement is stamped with:
jax.profiler traces, the reduction of a trace to per-op device time, the
table of published peaks keyed by ``device_kind``, and the card's name and
power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import contextlib
import glob
import os
import re
import subprocess
import time

import jax

# Published dense peaks, keyed by ``jax.devices()[0].device_kind``.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, without sparsity (the
# rates assume the full 700 W power limit; a card set lower cannot hold them).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_tbps": 3.35},
}


def peaks(device_kind: str) -> dict:
    """Peak bf16 TFLOP/s and HBM TB/s of ``device_kind``; unknown kinds raise."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {device_kind!r}; add it to PEAKS")
    return PEAKS[device_kind]


def device_info() -> dict:
    """Platform, kind and count of the devices JAX was started with."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def xla_cost(jitted, *args, compiled: bool = True) -> dict:
    """XLA's cost analysis (``flops``, ``bytes accessed``) of one call.
    ``compiled=False`` analyses the lowered, pre-optimization program with
    the arguments placed on the host CPU, because only the CPU backend
    analyses programs it has not compiled: no device compile, and FLOPs are
    shape-determined.  The process needs the CPU platform beside the GPU
    (``JAX_PLATFORMS=cuda,cpu``, JAX's default).  A missing count raises."""
    if compiled:
        cost = jitted.lower(*args).compile().cost_analysis()
    else:
        cost = jitted.lower(*jax.device_put(args, jax.devices("cpu")[0])).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    if not cost or float(cost.get("flops", 0.0)) <= 0:
        raise RuntimeError(f"XLA cost analysis counted no flops: {cost}")
    return cost


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a TensorBoard-viewable device trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def latest_xplane(log_dir: str) -> str:
    """Path of the newest ``.xplane.pb`` that :func:`trace` wrote under ``log_dir``."""
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU:") -> list[dict]:
    """Every XLA operation event on the planes whose name starts with
    ``plane_prefix``: ``{name, hlo_op, hlo_module, start_ns, dur_ns}``.
    On a GPU an event is one kernel; ``hlo_op`` names the HLO instruction
    that launched it.  ``plane_prefix="/host:CPU"`` reads a CPU trace."""
    events = []
    for plane in jax.profiler.ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue
                events.append({
                    "name": ev.name, "hlo_op": stats["hlo_op"],
                    "hlo_module": stats.get("hlo_module", ""),
                    "start_ns": ev.start_ns, "dur_ns": ev.duration_ns,
                })
    return events


def busy_ns(events: list[dict]) -> float:
    """Length of the union of the events' intervals: time the device was busy."""
    total, end = 0.0, float("-inf")
    for ev in sorted(events, key=lambda e: e["start_ns"]):
        s, e = ev["start_ns"], ev["start_ns"] + ev["dur_ns"]
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


_COMPUTATION = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$")
_INSTRUCTION = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=([%\w.\-, ]+)")
_TARGET = re.compile(r'custom_call_target="([^"]*)"')


def _opcode(line: str) -> str:
    """Opcode of an HLO instruction line (custom calls: their target)."""
    target = _TARGET.search(line)
    if target:
        return target.group(1)
    rest = line.split(" = ", 1)[1]
    if rest.startswith("("):  # tuple-shaped result
        depth = 0
        for i, ch in enumerate(rest):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if depth == 0:
                rest = rest[i + 1:]
                break
    else:
        rest = rest.split(" ", 1)[-1]
    return rest.strip().split("(", 1)[0]


def hlo_scopes(hlo_text: str, scopes) -> dict[str, frozenset]:
    """Map each instruction of a compiled HLO module to the ``jax.named_scope``
    names among ``scopes`` that its own metadata or the computations it calls
    (a fusion's body) carry.  An instruction in none of them (XLA drops the
    metadata of some instructions it creates) maps to ``{"other:<opcode>"}``.
    ``hlo_text`` is ``compiled.as_text()``."""
    patterns = {s: re.compile(r"(?<![\w])" + re.escape(s) + r"(?![\w])") for s in scopes}

    def tags(op_name):
        return {s for s, p in patterns.items() if p.search(op_name)}

    comp_tags: dict[str, set] = {}
    comp_insts: dict[str, list] = {}
    inst_tags: dict[str, set] = {}
    inst_calls: dict[str, list] = {}
    inst_opcode: dict[str, str] = {}
    current = None
    for line in hlo_text.splitlines():
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            name = m.group(1)
            op = _OP_NAME.search(line)
            inst_tags[name] = tags(op.group(1)) if op else set()
            comp_tags[current] |= inst_tags[name]
            comp_insts[current].append(name)
            inst_opcode[name] = _opcode(line)
            calls = _CALLS.search(line)
            if calls:
                inst_calls[name] = [c.strip().lstrip("%") for c in calls.group(1).split(",")]
            continue
        m = _COMPUTATION.match(line)
        if m:
            current = m.group(1)
            comp_tags.setdefault(current, set())
            comp_insts.setdefault(current, [])

    memo: dict[str, frozenset] = {}

    def closure(comp):
        # tags of a called computation, including the ones it calls in turn
        if comp not in memo:
            memo[comp] = frozenset()  # guards against cycles
            found = set(comp_tags.get(comp, ()))
            for inst in comp_insts.get(comp, ()):
                for callee in inst_calls.get(inst, ()):
                    found |= closure(callee)
            memo[comp] = frozenset(found)
        return memo[comp]

    result = {}
    for name, own in inst_tags.items():
        found = set(own)
        for callee in inst_calls.get(name, ()):
            found |= closure(callee)
        result[name] = frozenset(found or {"other:" + inst_opcode[name]})
        # a kernel launched from a CUDA graph ("command buffer") carries the
        # graph's hlo_op; its own name is the instruction's, '.'/'-' -> '_'
        result.setdefault(re.sub(r"[.\-]", "_", name), result[name])
    return result


def attribute(events: list[dict], scopes_of: dict[str, frozenset]) -> dict[str, float]:
    """Sum event time (ns) by the named scopes of the instruction that ran it.
    A kernel whose fusion spans several scopes counts under their joined
    name (``"cond_bn+conv"``); one whose instruction is not in the module
    under ``"other"``.  Kernels are matched by ``hlo_op``, else by their
    own name (XLA names a fusion's kernel after the instruction)."""
    out: dict[str, float] = {}
    for ev in events:
        key = ev["hlo_op"] if ev["hlo_op"] in scopes_of else ev["name"]
        label = "+".join(sorted(scopes_of.get(key, ()))) or "other"
        out[label] = out.get(label, 0.0) + ev["dur_ns"]
    return out


class StepTimer:
    """Rolling steps/sec meter; call ``tick()`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self):
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


def annotate(name: str):
    """Named region for profile traces."""
    return jax.profiler.TraceAnnotation(name)
