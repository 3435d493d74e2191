"""The port's tracing: named host spans at its layer boundaries, counters,
and the ``-profile`` trace of the CLIs.

    with tracing.span("pk2/train.forward"):
        ...
    tracing.count("search.captures", seconds)

Tracing is off by default. Off, and with no torch profiler recording,
``span`` returns one shared null context after two checks of module flags
(this module's and ``torch.autograd.profiler``'s): no allocation, no
``record_function``, no CUDA event, and nothing that waits for the device,
ever. While a torch profiler records, a span enters a
``torch.profiler.record_function`` of its name, so that the profiler's CUPTI
correlation puts the kernels launched inside it down to it, whoever started
the profiler. On (``enable()``), each span is also kept in memory (name,
native thread id, start, end, the enclosing span on its thread). Times are
``time.time_ns()``, the clock a torch.profiler chrome trace stamps its host
events on: a span's start lies tens of µs after its event's
``baseTimeNanoseconds + ts·1000`` (up to a thread switch between the two
stamps). ``take()`` returns the kept spans and the counters and clears them.

A thread started before the profiler sees it as off, and its
``record_function``s leave nothing in the trace (``device_prefetch``'s
worker is one). Its spans are kept all the same, and ``StepProfiler``
writes the spans its trace lacks into it, on their own thread ids.

Span names start with ``pk2/``. Counters are counted whether tracing is on
or not: ``count`` is for rare events only (a search's capture).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "pk2/"
PROFILE_START, PROFILE_STEPS = 2, 20
MATCH_NS = 1_000_000  # a kept span and a trace event of its name and thread within 1 ms


class Span(NamedTuple):
    name: str
    tid: int                # native thread id, as a chrome trace's ``tid``
    start_ns: int           # time.time_ns()
    end_ns: int
    id: int
    parent: Optional[int]   # id of the enclosing span on the same thread


_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
_ids = itertools.count()
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> dict:
    """{"spans": [Span] by start, "counters": {name: (count, sum)},
    "main_tid": the main thread's native id}; clears both."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return {"spans": sorted(spans, key=lambda s: s.start_ns), "counters": counters,
            "main_tid": threading.main_thread().native_id}


def count(name: str, value: float) -> None:
    """Add one event of ``value`` to the counter ``name``."""
    with _lock:
        n, total = _counters.get(name, (0, 0.0))
        _counters[name] = (n + 1, total + value)


class _Open:
    """A kept span, started when made; ``__exit__`` ends it."""

    __slots__ = ("name", "rf", "stack", "id", "parent", "tid", "start")

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()
        self.start = time.time_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.name, self.stack, self.id = name, stack, next(_ids)
        self.parent = stack[-1] if stack else None
        self.tid = threading.get_native_id()
        stack.append(self.id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.id in self.stack:
            self.stack.remove(self.id)
        self.rf.__exit__(None, None, None)
        with _lock:
            _spans.append(Span(self.name, self.tid, self.start, end, self.id, self.parent))
        return False


def span(name: str):
    """A context that marks ``name``: kept while tracing is on, a
    ``record_function`` while a torch profiler records, nothing otherwise."""
    if _on:
        return _Open(name)
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def backward_span(loss: torch.Tensor, name: str = "pk2/train.backward") -> None:
    """Mark ``name`` as ``span`` does around the backward pass that
    ``loss.backward()`` will run: opened by the loss's grad-fn pre-hook on the
    thread that runs the pass (on CUDA the autograd engine's device thread,
    which launches the backward's kernels) and closed by the engine's
    end-of-pass callback."""
    if loss.grad_fn is None or not (_on or _profiler._is_profiler_enabled):
        return
    keep = _on

    def pre(_grads):
        opened = _Open(name) if keep else torch.profiler.record_function(name)
        opened.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: opened.__exit__(None, None, None))

    loss.grad_fn.register_prehook(pre)


class StepProfiler:
    """A CLI's ``-profile DIR``: torch.profiler (host, and the card's
    kernels on CUDA) over steps ``start`` to ``start + steps`` (counted from
    0) with program tracing on; on close, ``DIR/trace.json`` with the kept
    spans the profiler did not see added, and in the log a table of the ops
    by time and the counters of the window (which ``take()`` clears)."""

    def __init__(self, trace_dir: Optional[str], dev: torch.device, log,
                 start: int = PROFILE_START, steps: int = PROFILE_STEPS):
        self.trace_dir, self.dev, self.log = trace_dir, dev, log
        self.start, self.stop = start, start + steps
        self.prof = None

    def step(self, step_no: int) -> None:
        """Call before step ``step_no`` runs."""
        if self.trace_dir and self.prof is None and step_no == self.start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            enable()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif self.prof is not None and step_no == self.stop:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof.__exit__(None, None, None)
        disable()
        taken = take()
        kept = taken["spans"]
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        added = add_unseen(doc, kept)
        with open(path, "w") as f:
            json.dump(doc, f)
        sort = "device_time_total" if self.dev.type == "cuda" else "cpu_time_total"
        self.log.info("profile (sorted by %s):\n%s", sort,
                      prof.key_averages().table(sort_by=sort, row_limit=25))
        self.log.info("profiler trace written to %s (%d program spans added from threads "
                      "the profiler did not see); counters (events, sum): %s", path, added,
                      taken["counters"])


def add_unseen(doc: dict, spans: list) -> int:
    """Add to the chrome trace ``doc`` each span that has no event of its
    name on its thread within ``MATCH_NS`` of its start; → spans added."""
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    seen: dict = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(PREFIX):
            seen.setdefault((e["name"], e.get("tid")), []).append(base + e["ts"] * 1e3)
    for v in seen.values():
        v.sort()
    pid = os.getpid()
    added = 0
    for s in spans:
        starts = seen.get((s.name, s.tid), [])
        i = bisect.bisect_left(starts, s.start_ns - MATCH_NS)
        if i < len(starts) and starts[i] <= s.start_ns + MATCH_NS:
            continue
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3})
        added += 1
    return added
