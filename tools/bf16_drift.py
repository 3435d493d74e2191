"""How far full-width backbones drift between the card and the CPU in bf16.

    python3 tools/bf16_drift.py

The same random inputs and weights through the TDNN 5x1024, the Transformer
4x1024 and the LSTM 4x1024 (8952 outputs, bf16 products with fp32 sums) on
the card and on the CPU: the max logit difference and the worst gradient
difference relative to its tensor's norm, with cuBLAS's
``allow_bf16_reduced_precision_reduction`` on and off; the error of one
bf16 GEMM against exact products at K = 240-8952; and the TDNN's drift layer
by layer (convolution, then layer norm). Needs a CUDA card.
"""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pykaldi2_tpu_torch import device as D  # noqa: E402
from pykaldi2_tpu_torch.config import ModelConfig  # noqa: E402
from pykaldi2_tpu_torch.models import build_model  # noqa: E402
from pykaldi2_tpu_torch.models.tdnn import dilated_conv, layer_norm  # noqa: E402
from pykaldi2_tpu_torch.ops.lstm_cuda import mm_bf16  # noqa: E402

MODELS = (dict(type="tdnn", hidden_size=1024, tdnn_dilations=(1, 1, 3, 3, 3)),
          dict(type="transformer", hidden_size=1024, num_layers=4, num_heads=8, ffn_size=2048),
          dict(type="lstm", hidden_size=1024, num_layers=4))


def gemm_errors(dev, g) -> None:
    for k in (240, 1024, 3072, 8952):
        a, b = torch.randn(5120, k, generator=g), torch.randn(k, 1024, generator=g)
        exact = a.bfloat16().double() @ b.bfloat16().double()
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            card = mm_bf16(a.to(dev), b.to(dev)).cpu().double()
            cpu = mm_bf16(a, b).double()
            scale = exact.abs().max()
            print(f"K={k} reduced={flag}: card vs exact "
                  f"{float((card - exact).abs().max() / scale):.3g}, CPU vs exact "
                  f"{float((cpu - exact).abs().max() / scale):.3g}", flush=True)


def model_drift(dev, kw, x, mask) -> None:
    m = build_model(ModelConfig(input_size=80, output_size=8952, compute_dtype="bfloat16", **kw),
                    generator=torch.Generator().manual_seed(1))
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        outs = {}
        for d in ("cpu", "cuda"):
            mm = copy.deepcopy(m).to(d)
            y = mm(x.to(d), mask.to(d))
            torch.log_softmax(y, -1).mean().backward()
            outs[d] = (y.detach().cpu(), {n: p.grad.cpu() for n, p in mm.named_parameters()})
        err = float((outs["cpu"][0] - outs["cuda"][0]).abs().max())
        rel = max(float((outs["cuda"][1][n] - gg).norm() / gg.norm())
                  for n, gg in outs["cpu"][1].items())
        print(f"{kw['type']} reduced={flag}: logits {err:.3g} (max "
              f"{float(outs['cpu'][0].abs().max()):.3g}), gradients {rel:.3g} of the norm",
              flush=True)
    if kw["type"] == "tdnn":
        per = {}
        for d in ("cpu", "cuda"):
            mm, h, out = copy.deepcopy(m).to(d), x.to(d), []
            with torch.no_grad():
                for lp, dil in zip(mm.nnet.layers, mm.nnet.dilations):
                    y = dilated_conv(h, lp.w, lp.b, dil, torch.bfloat16)
                    h = layer_norm(torch.relu(y), lp.ln_scale, lp.ln_bias)
                    out += [y.cpu(), h.cpu()]
            per[d] = out
        print("tdnn layer by layer (conv, layer norm):",
              [f"{float((a - b).abs().max()):.2g}" for a, b in zip(per["cpu"], per["cuda"])],
              flush=True)


def main() -> int:
    dev = D.resolve_device("cuda")
    g = torch.Generator().manual_seed(0)
    gemm_errors(dev, g)
    x, mask = torch.randn(2, 80, 80, generator=g) * 3, torch.ones(2, 80)
    for kw in MODELS:
        model_drift(dev, kw, x, mask)
    return 0


if __name__ == "__main__":
    sys.exit(main())
