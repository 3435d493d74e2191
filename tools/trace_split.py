"""Where a benchmark cell's traced steps spend the card's time, by the
program's own spans (``pykaldi2_tpu_torch/utils/tracing.py``).

    python3 tools/trace_split.py --workload lstm.se_mmi_otf --seed 7 --seconds 30 \\
        [--spans kept|marks|none] [--root DIR] [--device cuda|cpu]

Runs the cell as ``benchmark/run.py --trace 1`` does, from the benchmark of
the checkout at ``--root`` (default: this one), with the program's spans
kept in memory and marked in the trace (``kept``: tracing on around the
traced steps), only marked (``marks``: what the benchmark's own traced run
sees, the program marking a running profiler's trace), or suppressed
(``none``). The last line of standard output is one JSON object:

  * ``result``: the benchmark's result (its per-layer metrics, device);
  * ``device_ms``: device ms a traced step launched under each ``pk2/`` span,
    and the kernels of the recurrences and the lattice forward-backward by
    the step span that launched them;
  * ``coverage``: the step spans' device ms over the busy ms a step;
  * ``idle_by_start``, ``idle_by_end``: the traced window's idle seconds by
    the innermost ``pk2/`` span open at each gap's start (or end) on the
    threads that act for the main thread (the main thread, and the thread of
    each ``pk2/train.backward``), from the trace's own events; ``owned``:
    the share of the idle time whose gaps start inside some ``pk2/`` span;
    ``first_gap_s``: the gap that opens the window (the device idle since the
    harness's sync before the traced steps), which starts inside none;
  * with ``kept``: ``host_ms``, the kept spans' host ms by name and thread
    (main or not), ``idle_by_start_kept`` (the same split from the kept
    spans' ``time.time_ns()`` times), ``clock`` (kept starts against their
    trace events: median and largest offset, µs), and five readings no
    benchmark reader takes yet:
    ``loader_batch_ms.ce``, ``idle_launch_share.ce``, ``compact_wait_ms.se``,
    ``idle_sync_share.se``, ``idle_loader_share.se``;
  * with ``--alternate N``: the idle share of 6N traced turns in the same
    process, the spans kept, marked or suppressed in turns (kept, marks,
    none, none, marks, kept), and the median of each mode's difference from
    the adjacent ``none`` turn: the spans' cost, free of the host's drift.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = ("pk2/train.forward", "pk2/train.backward", "pk2/optimizer.step")
KERNELS = ("lstmp_fwd_kernel", "lstmp_bwd_kernel", "lstm_fwd_kernel", "lstm_bwd_kernel",
           "band_fwd_kernel", "band_bwd_kernel")  # K5, K6, K2, K3, K7, K8
SHARES = {"idle_launch_share.ce": STEP, "idle_sync_share.se": ("pk2/search.compact",),
          "idle_loader_share.se": ("pk2/loader.batch", "pk2/loader.wait")}


def window(events: list, trace_mod):
    """(t0, t1, gaps) of the traced window in µs, as ``trace.parse`` sets
    them."""
    xs = [e for e in events if e.get("ph") == "X"]
    top = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] in trace_mod.TOP_SPANS]
    t0 = min(e["ts"] for e in top)
    t1 = max(e["ts"] + e["dur"] for e in top)
    dev = [e for e in xs if e.get("cat") in trace_mod.DEVICE_CATS and e["ts"] < t1
           and e["ts"] + e["dur"] > t0]
    return t0, t1, trace_mod._busy_and_gaps(dev, t0, t1)[1]


def timeline(intervals: list):
    """(times, names open from each time on, innermost first) over
    ``intervals`` [(start, end, name)]: on the threads that act for the main
    thread they nest, so the innermost is the latest start."""
    edges = sorted([(a, 1, i) for i, (a, _b, _n) in enumerate(intervals)]
                   + [(b, 0, i) for i, (_a, b, _n) in enumerate(intervals)])
    opened: set = set()
    times, chains = [], []
    for t, is_start, i in edges:
        (opened.add if is_start else opened.discard)(i)
        chain = tuple(intervals[j][2] for j in sorted(opened, key=lambda j: -intervals[j][0]))
        if times and times[-1] == t:
            chains[-1] = chain
        else:
            times.append(t)
            chains.append(chain)
    return times, chains


def split(gaps: list, intervals: list, at: int) -> list:
    """[(gap seconds, chain open at the gap's start (at=0) or end (1))];
    gaps and intervals in the same unit, µs."""
    times, chains = timeline(intervals)
    out = []
    for gap in gaps:
        i = bisect.bisect_right(times, gap[at]) - 1
        out.append(((gap[1] - gap[0]) * 1e-6, chains[i] if i >= 0 else ()))
    return out


def by_inner(owners: list) -> dict:
    out: dict = {}
    for s, chain in owners:
        key = chain[0] if chain else "none"
        out[key] = out.get(key, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def share(owners: list, names, window_s: float) -> float:
    return 100.0 * sum(s for s, chain in owners if set(names) & set(chain)) / window_s


def analyse(doc: dict, tr, kept, trace_mod) -> dict:
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    xs = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    main_tid = next(e["tid"] for e in xs if e["name"] in trace_mod.TOP_SPANS)
    tids = {main_tid} | {e["tid"] for e in xs if e["name"] == "pk2/train.backward"}
    pk2 = [e for e in xs if e["name"].startswith("pk2/")]
    intervals = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in pk2 if e["tid"] in tids]
    t0, _t1, gaps = window(events, trace_mod)
    steps = tr.steps
    starts = split(gaps, intervals, 0)
    idle_s = sum(s for s, _c in starts)
    names = sorted({e["name"] for e in pk2})
    dev_ms = {n: 1e3 * tr.span_device_s(n) / steps for n in names}
    for k in KERNELS:
        ks = [(d, sp) for name, d, sp in tr.kernels if k in name]
        if ks:
            dev_ms[k] = {"all": 1e3 * sum(d for d, _ in ks) / steps,
                         **{n: 1e3 * sum(d for d, sp in ks if n in sp) / steps for n in STEP}}
    step_ms = 1e3 * tr.span_device_s(*STEP) / steps
    out = {"steps": steps, "window_s": tr.window_s, "busy_s": tr.busy_s, "idle_s": idle_s,
           "device_ms": dev_ms,
           "coverage": step_ms / (1e3 * tr.busy_s / steps) if tr.busy_s else None,
           "fwd_ms.ce": dev_ms.get("pk2/train.forward"),
           "bwd_ms.ce": dev_ms.get("pk2/train.backward"),
           "train_ms.se": step_ms,
           "idle_by_start": by_inner(starts), "idle_by_end": by_inner(split(gaps, intervals, 1)),
           "owned": sum(s for s, c in starts if c) / idle_s if idle_s else None,
           "first_gap_s": starts[0][0] if starts and gaps[0][0] == t0 else 0.0}
    out.update({k: share(starts, v, tr.window_s) for k, v in SHARES.items()})
    if kept is None or not kept["spans"]:
        return out
    spans = kept["spans"]
    main = kept["main_tid"]
    host: dict = {}
    for s in spans:
        key = f"{s.name} ({'main' if s.tid == main else 'thread ' + str(s.tid)})"
        n, total = host.get(key, (0, 0.0))
        host[key] = (n + 1, total + 1e-6 * (s.end_ns - s.start_ns))
    out["host_ms"] = {k: {"n": n, "ms_each": t / n} for k, (n, t) in sorted(host.items())}
    ktids = {main} | {s.tid for s in spans if s.name == "pk2/train.backward"}
    kiv = [((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3, s.name)
           for s in spans if s.tid in ktids]
    kstarts = split(gaps, kiv, 0)
    out["idle_by_start_kept"] = by_inner(kstarts)
    out.update({k + " (kept)": share(kstarts, v, tr.window_s) for k, v in SHARES.items()})
    trace_starts: dict = {}
    for e in pk2:
        trace_starts.setdefault((e["name"], e["tid"]), []).append(base + e["ts"] * 1e3)
    offs = []
    for s in spans:
        ts = trace_starts.get((s.name, s.tid))
        if ts:
            offs.append(min((t - s.start_ns for t in ts), key=abs) / 1e3)
    if offs:
        out["clock"] = {"n": len(offs), "median_us": statistics.median(offs),
                        "max_abs_us": max(abs(o) for o in offs)}
    loader = [s for s in spans if s.name == "pk2/loader.batch" and s.tid != main]
    if loader:
        out["loader_batch_ms.ce"] = 1e-6 * sum(s.end_ns - s.start_ns for s in loader) / len(loader)
    compact = [s for s in spans if s.name == "pk2/search.compact"]
    if compact:
        out["compact_wait_ms.se"] = 1e-6 * sum(s.end_ns - s.start_ns for s in compact) / steps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--spans", choices=("kept", "marks", "none"), default="kept")
    p.add_argument("--root", default=ROOT)
    p.add_argument("--device", default="cuda")
    p.add_argument("--alternate", type=int, default=0,
                   help="first run the traced steps 6N times, kept, marks, none, none, "
                        "marks, kept, N times over, and report each turn's idle share")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    import torch
    import torch.profiler

    import run as bench_run
    import trace as trace_mod
    from pykaldi2_tpu_torch.device import resolve_device
    from pykaldi2_tpu_torch.utils import tracing

    os.environ.update(bench_run.cache_dirs(root))
    torch.set_num_threads(2)
    dev = resolve_device(args.device)
    got: dict = {"mode": args.spans}
    span, backward_span = tracing.span, tracing.backward_span

    def read(prof, path, steps):
        prof.export_chrome_trace(path)
        with open(path) as f:
            got["doc"] = json.load(f)
        os.remove(path)
        return trace_mod.parse(got["doc"]["traceEvents"], steps)

    def set_mode(mode: str) -> None:
        got["mode"] = mode
        tracing.span = span if mode != "none" else (lambda name: tracing._NULL)
        tracing.backward_span = (backward_span if mode != "none"
                                 else (lambda loss, name=None: None))

    class Profile(torch.profiler.profile):
        def __enter__(self):
            if got["mode"] == "kept":
                tracing.enable()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            tracing.disable()
            got["kept"] = tracing.take()
            return out

    trace_mod.read = read
    torch.profiler.profile = Profile
    set_mode(args.spans)
    ctx = bench_run.Context(bench_run.load_bench(root), args.workload, args.seed,
                            args.seconds, True, dev, T_START)
    turns = []
    if args.alternate:
        driver = importlib.import_module("drivers." + ctx.mix["driver"])
        traced = driver._traced

        def alternating(*a, **kw):
            # kept, marks, none, then back: a drift of the host cancels
            for mode in ("kept", "marks", "none", "none", "marks", "kept") * args.alternate:
                set_mode(mode)
                tr = traced(*a, **kw)[0]
                turns.append((mode, 100.0 * (1.0 - tr.busy_s / tr.window_s)))
            set_mode(args.spans)
            return traced(*a, **kw)

        driver._traced = alternating
    result = bench_run.execute(ctx)
    tr = trace_mod.parse(got["doc"]["traceEvents"], ctx.mix["trace_steps"])
    out = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
           "result": {k: result[k] for k in ("correct", "metrics", "device")}}
    out.update(analyse(got["doc"], tr, got.get("kept"), trace_mod))
    if turns:
        idle = {m: [v for k, v in turns if k == m] for m in ("kept", "marks", "none")}
        n = len(idle["none"])
        out["alternate"] = {
            "idle_pct": idle,
            "median_diff_vs_none": {m: statistics.median(idle[m][i] - idle["none"][i]
                                                         for i in range(n))
                                    for m in ("kept", "marks")}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
