"""The plain reference against the program's CPU path at a tiny size."""

from __future__ import annotations

import numpy as np
import torch

from reference import am


def _fe():
    return {"samp_freq": 16000.0, "frame_length_ms": 25.0, "frame_shift_ms": 10.0,
            "dither": 0.0, "preemph_coeff": 0.97, "num_mel_bins": 80, "low_freq": 20.0,
            "high_freq": 0.0, "cmvn_norm_means": True}


def test_mel_banks_match_the_program():
    from pykaldi2_tpu_torch.config import FrameOpts, MelOpts
    from pykaldi2_tpu_torch.frontend.mel import mel_banks

    want = mel_banks(MelOpts(num_bins=80, low_freq=20.0), FrameOpts())
    got = am.mel_banks(80, 20.0, 0.0, 16000.0, 512)
    assert np.abs(got - want).max() < 1e-6


def test_fbank_matches_the_program():
    from pykaldi2_tpu_torch.config import FbankOpts, FrameOpts, MelOpts
    from pykaldi2_tpu_torch.frontend.fused import fused_fbank

    rng = np.random.default_rng(3)
    wave = torch.from_numpy(np.rint(rng.standard_normal((3, 400 + 29 * 160)) * 3000)
                            .astype(np.float32))
    want = fused_fbank(wave, FbankOpts(frame_opts=FrameOpts(dither=0.0),
                                       mel_opts=MelOpts(num_bins=80)))
    got = am.fbank(wave, 30, _fe())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-3


def test_lstm_direction_matches_the_program_in_fp32():
    from pykaldi2_tpu_torch.models.lstm import LSTMStack

    torch.manual_seed(0)
    for proj, bidi in ((0, False), (4, True)):
        net = LSTMStack(5, 8, 2, bidirectional=bidi, proj_size=proj,
                        compute_dtype=torch.float32)
        x = torch.randn(3, 7, 5)
        mask = torch.ones(3, 7)
        mask[1, 5:] = 0.0
        want = net(x, mask).detach()
        params = {"nnet." + k: v.detach() for k, v in net.named_parameters()}
        params.update(out_w=torch.zeros(want.shape[-1], 2), out_b=torch.zeros(2))
        h = x
        dirs = ("fwd", "bwd") if bidi else ("fwd",)
        for layer in range(2):
            outs = []
            for d in dirs:
                pre = f"nnet.layers.{layer}.{d}."
                p = {k: params[pre + k] for k in ("wx", "wh", "b", "wp") if pre + k in params}
                outs.append(am.lstm_direction(h, mask, p, "fp32", reverse=d == "bwd"))
            h = torch.cat(outs, dim=-1)
        # the program's recurrence takes W_h and r in bf16, the reference fp32
        assert float((h - want).abs().max()) < 2e-2


def test_row_blocks_do_not_change_the_steps():
    torch.manual_seed(1)
    model = {"type": "lstm", "hidden_size": 8, "num_layers": 1, "proj_size": 0,
             "bidirectional": False, "output_size": 6}
    params = {"nnet.layers.0.fwd.wx": torch.randn(80, 32) * 0.1,
              "nnet.layers.0.fwd.wh": torch.randn(8, 32) * 0.1,
              "nnet.layers.0.fwd.b": torch.randn(32) * 0.1,
              "out_w": torch.randn(8, 6) * 0.1, "out_b": torch.zeros(6)}
    batches = []
    for _ in range(2):
        mask = torch.ones(4, 10)
        mask[3, 6:] = 0.0
        labels = torch.randint(0, 6, (4, 10)).int()
        labels[mask == 0] = -1
        batches.append({"wave": torch.randn(4, 400 + 9 * 160) * 3000, "labels": labels,
                        "mask": mask})
    cfg = {"model": model, "frontend": _fe()}
    opt = {"lr": 1e-3, "grad_clip": 5.0}
    whole = am.train_steps({k: v.clone() for k, v in params.items()}, batches, cfg, opt, "fp32")
    rows = am.train_steps({k: v.clone() for k, v in params.items()}, batches, cfg, opt, "fp32",
                          block_rows=1)
    for a, b in zip(whole["loss"], rows["loss"]):
        assert abs(a - b) < 1e-5 * abs(a)
    for k in params:
        assert abs(whole["grad"][k] - rows["grad"][k]) <= 1e-5 * whole["grad"][k] + 1e-9
