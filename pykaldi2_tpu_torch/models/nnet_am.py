"""NnetAM: backbone + output projection over senones; model registry.

Port of pykaldi2_tpu/models/nnet_am.py (reference behavior:
pykaldi2/models/lstm.py ``NnetAM(nnet, hidden_size, output_size)``).
Parameters keep the JAX names and layouts: ``out_w`` [hidden, C], ``out_b``
[C]; the backbone's live under ``nnet``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pykaldi2_tpu_torch.config import ModelConfig
from pykaldi2_tpu_torch.models.lstm import LSTMStack
from pykaldi2_tpu_torch.models.tdnn import TDNNStack
from pykaldi2_tpu_torch.models.transformer import TransformerStack
from pykaldi2_tpu_torch.ops.lstm_cuda import linear


class NnetAM(nn.Module):
    """Backbone + output linear layer; per-frame senone logits [B, T, C] fp32."""

    def __init__(self, nnet: nn.Module, output_size: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nnet = nnet
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        hidden = nnet.output_size
        bound = np.sqrt(1.0 / hidden)
        self.out_w = nn.Parameter(
            torch.rand(hidden, output_size, generator=generator) * (2 * bound) - bound)
        self.out_b = nn.Parameter(
            torch.rand(output_size, generator=generator) * (2 * bound) - bound)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.nnet(x, mask, train=train, generator=generator)
        return linear(h, self.out_w, self.compute_dtype) + self.out_b


def build_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None) -> NnetAM:
    """ModelConfig → NnetAM (parameters on the CPU; move with ``.to``)."""
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    bidi = cfg.bidirectional or cfg.type == "blstm"
    if cfg.type in ("lstm", "blstm"):
        nnet = LSTMStack(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                         dropout=cfg.dropout, bidirectional=bidi, proj_size=cfg.proj_size,
                         compute_dtype=cd, generator=generator)
    elif cfg.type == "tdnn":
        nnet = TDNNStack(cfg.input_size, cfg.hidden_size, dilations=cfg.tdnn_dilations,
                         kernel=cfg.tdnn_kernel, dropout=cfg.dropout, compute_dtype=cd,
                         generator=generator)
    elif cfg.type == "transformer":
        nnet = TransformerStack(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                                cfg.num_heads, cfg.ffn_size, dropout=cfg.dropout,
                                compute_dtype=cd, generator=generator)
    else:
        raise ValueError(f"unknown model type {cfg.type!r}")
    return NnetAM(nnet, cfg.output_size, compute_dtype=cd, generator=generator)
