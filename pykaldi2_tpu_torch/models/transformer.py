"""Transformer acoustic model (encoder only): pre-LN blocks, bf16 products
with fp32 sums, an fp32 softmax and key-padding masks.

Port of pykaldi2_tpu/models/transformer.py. Every product follows the
reference's rounding: the dense layers go through ``ops.lstm_cuda.linear``,
and the two attention products (q·kᵀ and weights·v, the reference's einsums
with ``preferred_element_type=float32``) through ``BmmBf16``, one batched
bf16 GEMM with an fp32 output over (batch, head) on the card. The softmax
runs in fp32 with a key-padding bias of -1e30, and its weights are rounded to
bf16 for the second product. ``F.scaled_dot_product_attention`` is not used:
it rounds differently (a bf16 softmax).

Parameters keep the JAX names and layouts: ``in_proj.{w,b}``,
``layers.<i>.{qkv,out,ffn1,ffn2}.{w [in, out], b}`` and
``layers.<i>.{ln1,ln2}_{scale,bias}``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pykaldi2_tpu_torch.models.tdnn import dropout, layer_norm
from pykaldi2_tpu_torch.ops.lstm_cuda import BmmBf16, linear

Tensor = torch.Tensor


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((t, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


class Dense(nn.Module):
    def __init__(self, in_size: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = np.sqrt(1.0 / in_size)
        self.w = nn.Parameter(torch.rand(in_size, out_size, generator=generator)
                              * (2 * bound) - bound)
        self.b = nn.Parameter(torch.rand(out_size, generator=generator) * (2 * bound) - bound)

    def forward(self, x: Tensor, compute_dtype: torch.dtype) -> Tensor:
        return linear(x, self.w, compute_dtype) + self.b


class TransformerLayer(nn.Module):
    def __init__(self, hidden: int, ffn: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.qkv = Dense(hidden, 3 * hidden, generator)
        self.out = Dense(hidden, hidden, generator)
        self.ffn1 = Dense(hidden, ffn, generator)
        self.ffn2 = Dense(ffn, hidden, generator)
        for name in ("ln1", "ln2"):
            setattr(self, f"{name}_scale", nn.Parameter(torch.ones(hidden)))
            setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(hidden)))


def _product(a: Tensor, b: Tensor, compute_dtype: torch.dtype) -> Tensor:
    """[N, M, K] @ [N, K, L] → fp32, bf16 operands under bf16 compute."""
    if compute_dtype == torch.bfloat16:
        return BmmBf16.apply(a, b)
    return torch.bmm(a.float(), b.float())


class TransformerStack(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, num_layers: int = 6,
                 num_heads: int = 8, ffn_size: int = 2048, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size must divide num_heads")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.output_size = hidden_size
        self.in_proj = Dense(input_size, hidden_size, generator)
        self.layers = nn.ModuleList(TransformerLayer(hidden_size, ffn_size, generator)
                                    for _ in range(num_layers))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x [B, T, D], mask [B, T] → [B, T, hidden] fp32."""
        cd = self.compute_dtype
        b, t, _ = x.shape
        nh, hd = self.num_heads, self.hidden_size // self.num_heads
        pos = torch.as_tensor(sinusoidal_positions(t, self.hidden_size), device=x.device)
        h = self.in_proj(x, cd) + pos
        use_dropout = train and self.dropout > 0.0
        if use_dropout and generator is None:
            raise ValueError("dropout enabled but no torch.Generator supplied")

        def drop(v):
            return dropout(v, self.dropout, generator) if use_dropout else v

        bias = None
        if mask is not None:  # [B, 1, 1, S] over keys
            bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).to(torch.float32)
        for lp in self.layers:
            hn = layer_norm(h, lp.ln1_scale, lp.ln1_bias)
            qkv = lp.qkv(hn, cd).reshape(b, t, 3, nh, hd)
            # [B, T, nh, hd] → [B·nh, T, hd]
            q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).reshape(b * nh, t, hd)
                       for i in range(3))
            logits = (_product(q, k.transpose(1, 2), cd) / np.sqrt(hd)).reshape(b, nh, t, t)
            if bias is not None:
                logits = logits + bias
            w = torch.softmax(logits, dim=-1).reshape(b * nh, t, t)
            ctx = _product(w, v, cd).reshape(b, nh, t, hd).permute(0, 2, 1, 3)
            h = h + drop(lp.out(ctx.reshape(b, t, self.hidden_size), cd))
            hn = layer_norm(h, lp.ln2_scale, lp.ln2_bias)
            h = h + drop(lp.ffn2(torch.relu(lp.ffn1(hn, cd)), cd))
        return h
