"""LSTM / BLSTM / LSTMP stack over the hand-written recurrence kernels
(K2/K3, and K5/K6 with a projection).

Port of pykaldi2_tpu/models/lstm.py (reference behavior: pykaldi2/models/
lstm.py ``LSTMStack`` wrapping ``torch.nn.LSTM``):

  * the input-to-gate projection for all timesteps is one GEMM outside the
    recurrence (bf16 operands, fp32 result under bf16 compute);
  * the recurrence is ``ops.lstm_cuda.LstmSeq`` (``LstmProjSeq`` with a
    projection, ``proj_size > 0``) — on CUDA the persistent kernels, on the
    CPU their plain versions; Wh and h (Wp and h_full) enter the recurrent
    products in bf16 (as in the reference's Pallas path), the cell is fp32;
  * masks carry state through padded frames unchanged (lstm.py:118-121),
    which also makes the reversed direction — time flipped around the same
    kernel, as lstm.py:93-97 does — right for right-padded batches.

Parameters keep the JAX layout: ``wx`` [D, 4H], ``wh`` [H or P, 4H], ``b``
[4H], ``wp`` [H, P] with a projection, gate order i, f, g, o; ``convert.py``
maps JAX parameter trees onto them. As the reference gates its kernels by
shape (lstm.py:87-103) and runs a scan otherwise, ``LstmSeq``/``LstmProjSeq``
take the kernels only where ``lstm_cuda.kernel_supported(H, P)`` holds: H
a multiple of 16 in [16, 1024], P a multiple of 16 in [16, H]. Any other
shape runs the plain versions (the same math) on the card, with one warning
per shape, decided from the shape before any launch. A shape inside the gate
always launches the kernels: one whose clusters the card cannot hold, or
whose kernel fails, raises.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from pykaldi2_tpu_torch.ops.lstm_cuda import LstmProjSeq, LstmSeq, linear

Tensor = torch.Tensor


def lstm_layer_init(input_size: int, hidden_size: int, proj_size: int = 0,
                    generator: Optional[torch.Generator] = None) -> dict:
    """Torch-convention init: U(-1/sqrt(H), 1/sqrt(H)) for all tensors (CPU);
    with ``proj_size`` also ``wp`` [H, P], and ``wh`` is [P, 4H]."""
    k = 1.0 / np.sqrt(hidden_size)

    def u(*shape):
        return torch.rand(shape, generator=generator) * (2 * k) - k

    p = {"wx": u(input_size, 4 * hidden_size),
         "wh": u(proj_size or hidden_size, 4 * hidden_size), "b": u(4 * hidden_size)}
    if proj_size:
        p["wp"] = u(hidden_size, proj_size)
    return p


def _layer_tm(p: Mapping[str, Tensor], x_tm: Tensor, mask_tm: Tensor, reverse: bool,
              compute_dtype: torch.dtype) -> Tensor:
    """One direction, time-major: x_tm [T, B, D], mask_tm [T, B] → [T, B, H or P]."""
    xp = linear(x_tm, p["wx"], compute_dtype) + p["b"]        # [T, B, 4H] fp32
    if reverse:
        xp, mask_tm = xp.flip(0), mask_tm.flip(0)
    if "wp" in p:
        ys = LstmProjSeq.apply(xp, p["wh"], p["wp"], mask_tm)
    else:
        ys = LstmSeq.apply(xp, p["wh"], mask_tm)
    return ys.flip(0) if reverse else ys


def lstm_layer_apply(
    params: Mapping[str, Tensor],
    x: Tensor,                       # [B, T, D]
    mask: Optional[Tensor] = None,   # [B, T] 1.0 on valid frames
    reverse: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tensor:
    """Run one (uni-directional) LSTM layer; returns [B, T, H or proj]."""
    b, t, _ = x.shape
    mask_tm = (torch.ones(t, b, device=x.device) if mask is None
               else mask.transpose(0, 1).to(torch.float32))
    ys = _layer_tm(params, x.transpose(0, 1), mask_tm, reverse, compute_dtype)
    return ys.transpose(0, 1)


class LSTMDirection(nn.Module):
    """Parameters of one direction of one layer, in the JAX layout."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = lstm_layer_init(input_size, hidden_size, proj_size, generator=generator)
        self.wx = nn.Parameter(init["wx"])
        self.wh = nn.Parameter(init["wh"])
        self.b = nn.Parameter(init["b"])
        self.wp = nn.Parameter(init["wp"]) if proj_size else None

    def as_dict(self) -> dict:
        d = {"wx": self.wx, "wh": self.wh, "b": self.b}
        if self.wp is not None:
            d["wp"] = self.wp
        return d


class LSTMStack(nn.Module):
    """Multi-layer (B)LSTM; mirrors the reference LSTMStack constructor.

    Dropout between layers draws from the ``generator`` passed to
    ``forward`` (a ``torch.Generator`` on the input's device)."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_layers: int,
        dropout: float = 0.0,
        bidirectional: bool = False,
        proj_size: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.proj_size = proj_size
        self.compute_dtype = compute_dtype
        self.output_size = (proj_size or hidden_size) * (2 if bidirectional else 1)
        dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
        self.layers = nn.ModuleList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else self.output_size
            self.layers.append(nn.ModuleDict(
                {d: LSTMDirection(in_size, hidden_size, proj_size, generator) for d in dirs}))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x [B, T, D], mask [B, T] → [B, T, output_size]."""
        b, t, _ = x.shape
        mask_tm = (torch.ones(t, b, device=x.device) if mask is None
                   else mask.transpose(0, 1).to(torch.float32))
        h = x.transpose(0, 1)                                     # time-major inside
        for layer, dirs in enumerate(self.layers):
            outs = [_layer_tm(dirs["fwd"].as_dict(), h, mask_tm, False, self.compute_dtype)]
            if self.bidirectional:
                outs.append(_layer_tm(dirs["bwd"].as_dict(), h, mask_tm, True,
                                      self.compute_dtype))
            h = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if train and self.dropout > 0.0 and layer < self.num_layers - 1:
                if generator is None:
                    raise ValueError("dropout enabled but no torch.Generator supplied")
                keep = 1.0 - self.dropout
                h = h * torch.bernoulli(torch.full_like(h, keep), generator=generator) / keep
        return h.transpose(0, 1)
