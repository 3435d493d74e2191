"""The work counted from shapes, against hand counts."""

from __future__ import annotations

import importlib.util
import math
import os
import sys

import peaks
from conftest import BENCH

sys.path.insert(0, os.path.join(BENCH, "metrics"))
import _shapes  # noqa: E402


def test_forward_flops_of_the_two_models():
    lstm = {"hidden_size": 1024, "num_layers": 4, "proj_size": 0, "bidirectional": False,
            "output_size": 8952}
    blstmp = dict(lstm, proj_size=512, bidirectional=True)
    # 4096*1104 + 3*4096*2048 + 1024*8952 multiply-adds
    assert _shapes.model_forward_flops(lstm, 80) == 2 * (4096 * 1104 + 3 * 4096 * 2048
                                                          + 1024 * 8952)
    assert math.isclose(_shapes.model_forward_flops(lstm, 80), 77.7e6, rel_tol=1e-3)
    assert math.isclose(_shapes.model_forward_flops(blstmp, 80), 111.9e6, rel_tol=1e-3)


def test_stack_flops_and_bytes_by_hand():
    # one unidirectional layer, D=3, H=2: x W_x is 3x8, r W_h is 2x8 a frame;
    # forward once, backward twice, but no data gradient of the input
    m = {"hidden_size": 2, "num_layers": 1, "proj_size": 0, "bidirectional": False,
         "output_size": 5}
    assert _shapes.stack_flops(m, 3, 10) == 2 * 10 * (3 * 16 + 2 * 24)
    # two layers: the second's input product gets its data gradient too
    m2 = dict(m, num_layers=2)
    assert _shapes.stack_flops(m2, 3, 1) == 2 * ((3 * 16 + 2 * 24) + (3 * 16 + 3 * 16))
    # a projected direction: r = h W_p (H=2 → P=1), W_h is 1x8
    mp = dict(m, proj_size=1)
    assert _shapes.stack_flops(mp, 3, 1) == 2 * (3 * (8 + 2) + 2 * 24)
    # bytes: fp32 input and output read and written twice a frame, the bf16
    # weights twice a step
    assert _shapes.stack_bytes(m, 3, 10, 2) == 2 * 4 * (3 + 2) * 10 + 2 * 2 * (24 + 16) * 2


def test_least_seconds():
    t, what = peaks.least_seconds(3.35e12, [(989e12, peaks.BF16_FLOPS)])
    assert math.isclose(t, 1.0) and what == "bytes"
    t, what = peaks.least_seconds(1.0, [(2 * 989e12, peaks.BF16_FLOPS), (67e12, 67e12)])
    assert math.isclose(t, 3.0) and what == "operations"


def test_roofline_reads_nothing_without_spans():
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", "lstmp_roofline.ce.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class T:
        steps = 1

        def span_device_s(self, *names):
            return 0.0

    class R:
        mix = {"driver": "ce_train"}
        config = {"proj_size": 512}
        trace = T()
        traced_frames = 100.0

    assert mod.read(R()) is None
