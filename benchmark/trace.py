"""Spans and the reading of a torch.profiler trace.

The harness marks what the host does with named ranges (``record_function``)
only while a trace is taken: the loop's own steps (``loader.next``,
``step.enqueue``, ``sync``), and layers, entered from module hooks around a
module's forward and its backward (from the grad node of its output until
the last of its parameters has its gradient). A kernel belongs to every
span whose range holds the host call that launched it (matched by CUPTI's
correlation id), whatever the kernel is named.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from dataclasses import dataclass, field

import torch

TOP_SPANS = ("loader.next", "step.enqueue", "sync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Named host ranges, recorded only while ``on``."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(name):
            yield


def layer_spans(module: torch.nn.Module, name: str, spans: Spans) -> list:
    """Hooks that put ``<name>.fwd`` around the module's forward and
    ``<name>.bwd`` around its backward; returns their handles."""
    params = [p for p in module.parameters() if p.requires_grad]
    state = {"bwd": None, "left": 0, "fwd": None}

    def pre(_mod, _args):
        if spans.on:
            state["fwd"] = torch.profiler.record_function(name + ".fwd")
            state["fwd"].__enter__()

    def post(_mod, _args, out):
        if state["fwd"] is not None:
            state["fwd"].__exit__(None, None, None)
            state["fwd"] = None
        if spans.on and torch.is_tensor(out) and out.grad_fn is not None:
            def bwd_pre(_grads):
                state["left"] = len(params)
                state["bwd"] = torch.profiler.record_function(name + ".bwd")
                state["bwd"].__enter__()
            out.grad_fn.register_prehook(bwd_pre)

    def accumulated(_p):
        if state["bwd"] is None:
            return
        state["left"] -= 1
        if state["left"] == 0:
            state["bwd"].__exit__(None, None, None)
            state["bwd"] = None

    return ([module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
            + [p.register_post_accumulate_grad_hook(accumulated) for p in params])


@dataclass
class Trace:
    """What one traced window holds."""

    window_s: float
    busy_s: float
    steps: int
    kernels: list = field(default_factory=list)   # (name, seconds, spans frozenset)
    idle_gaps: dict = field(default_factory=dict)  # top span → seconds

    def span_device_s(self, *names: str) -> float:
        """Device seconds of the operations launched under any of ``names``."""
        want = set(names)
        return sum(d for _n, d, sp in self.kernels if sp & want)

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, d, _sp in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def read(prof, path: str, steps: int) -> Trace:
    """Export ``prof``'s trace to ``path``, read it, delete the file."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, steps)


def parse(events: list, steps: int) -> Trace:
    xs = [e for e in events if e.get("ph") == "X"]
    annots = [e for e in xs if e.get("cat") == "user_annotation"]
    top = [e for e in annots if e["name"] in TOP_SPANS]
    if not top:
        raise RuntimeError("the trace holds none of the harness's spans")
    t0 = min(e["ts"] for e in top)
    t1 = max(e["ts"] + e["dur"] for e in top)
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.setdefault(e["args"]["correlation"], (e["tid"], e["ts"]))
    by_tid: dict = {}
    for e in annots:
        by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for v in by_tid.values():
        v.sort()
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < t1 and
           e["ts"] + e["dur"] > t0]
    kernels = []
    for e in dev:
        spans = frozenset()
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            tid, ts = launch
            spans = frozenset(n for a, b, n in by_tid.get(tid, ()) if a <= ts <= b)
        kernels.append((e["name"], e["dur"] * 1e-6, spans))
    busy, gaps = _busy_and_gaps(dev, t0, t1)
    starts = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in top)
    idle: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, (mid, float("inf"), "")) - 1
        name = starts[i][2] if i >= 0 and starts[i][1] >= mid else "none"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Trace((t1 - t0) * 1e-6, busy * 1e-6, steps, kernels, idle)


def _busy_and_gaps(dev: list, t0: float, t1: float):
    """Union of the device intervals inside [t0, t1] (µs), and its gaps."""
    iv = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev)
    busy, gaps, cur = 0.0, [], t0
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < t1:
        gaps.append((cur, t1))
    return busy, gaps
