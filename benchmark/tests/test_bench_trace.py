"""Reading a trace: kernels belong to the spans that hold their launch,
whatever their names; idle gaps are named by what the host was doing."""

from __future__ import annotations

import torch

import trace as trace_mod


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_parse_attributes_by_launch_not_by_name():
    events = [
        _x("user_annotation", "step.enqueue", 0, 100),
        _x("user_annotation", "lstm.fwd", 10, 20),
        _x("user_annotation", "lstm.bwd", 50, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernelExC", 15, 1, corr=1),
        _x("cuda_driver", "cuLaunchKernelEx", 55, 1, tid=2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 1, corr=3),
        _x("kernel", "anything_a", 20, 30, tid=7, corr=1),
        _x("kernel", "anything_b", 60, 10, tid=7, corr=2),
        _x("kernel", "lstm_named_but_outside", 90, 20, tid=7, corr=3),
        _x("user_annotation", "sync", 100, 50),
    ]
    t = trace_mod.parse(events, steps=1)
    assert abs(t.window_s - 150e-6) < 1e-12
    assert abs(t.span_device_s("lstm.fwd") - 30e-6) < 1e-12
    assert abs(t.span_device_s("lstm.fwd", "lstm.bwd") - 40e-6) < 1e-12
    assert abs(t.busy_s - 60e-6) < 1e-12
    # gaps [0, 20), [50, 60) and [70, 90) under step.enqueue, [110, 150) in sync
    assert abs(t.idle_gaps["step.enqueue"] - 50e-6) < 1e-12
    assert abs(t.idle_gaps["sync"] - 40e-6) < 1e-12
    b = t.breakdown()
    assert b["device_ops"][0][0] == "anything_a" and len(b["idle_gaps"]) == 2


def test_layer_spans_cover_forward_and_backward():
    from torch.profiler import ProfilerActivity, profile

    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Tanh(), torch.nn.Linear(4, 1))
    spans = trace_mod.Spans()
    handles = trace_mod.layer_spans(net[0], "layer", spans)
    spans.on = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        net(torch.randn(3, 4)).sum().backward()
    spans.on = False
    for h in handles:
        h.remove()
    names = [e.name for e in prof.events()]
    assert "layer.fwd" in names and "layer.bwd" in names
