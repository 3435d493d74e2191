"""TDNN acoustic model: dilated 1-D convolutions over time.

Port of pykaldi2_tpu/models/tdnn.py (reference scope: Kaldi TDNNs, splice +
affine + ReLU + renorm stacks). Each layer is a dilated convolution, ReLU and
an fp32 layer norm over features (eps 1e-5); the mask multiplies the input of
every layer so that padding does not leak through the convolution context,
and dropout follows every layer but the last.

The reference convolves bf16 operands with fp32 sums and an fp32 output
(``preferred_element_type``). ``F.conv1d`` on bf16 would return bf16 and so
round once more; here the dilated context is built by padding and stacking
``kernel`` shifted views of the input (im2col), and the layer is one product
through ``ops.lstm_cuda.linear``: a cuBLAS bf16 GEMM with an fp32 output on
the card, exact bf16 products on the CPU.

Parameters keep the JAX names and layouts: ``layers.<i>.w`` [kernel, in,
out], ``b``, ``ln_scale``, ``ln_bias`` [out].
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from pykaldi2_tpu_torch.ops.lstm_cuda import linear

Tensor = torch.Tensor


def layer_norm(y: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """fp32 layer norm over the last axis, as the reference writes it."""
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * scale + bias


def dropout(y: Tensor, rate: float, generator: Optional[torch.Generator]) -> Tensor:
    if generator is None:
        raise ValueError("dropout enabled but no torch.Generator supplied")
    keep = 1.0 - rate
    return y * torch.bernoulli(torch.full_like(y, keep), generator=generator) / keep


class TDNNLayer(nn.Module):
    def __init__(self, kernel: int, in_size: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = np.sqrt(1.0 / (kernel * in_size))

        def u(*shape):
            return torch.rand(shape, generator=generator) * (2 * bound) - bound

        self.w = nn.Parameter(u(kernel, in_size, out_size))
        self.b = nn.Parameter(u(out_size))
        self.ln_scale = nn.Parameter(torch.ones(out_size))
        self.ln_bias = nn.Parameter(torch.zeros(out_size))


def dilated_conv(x: Tensor, w: Tensor, b: Tensor, dil: int,
                 compute_dtype: torch.dtype) -> Tensor:
    """x [B, T, D], w [kernel, D, O] → fp32 [B, T', O]: the reference's
    ``conv_general_dilated`` with padding (kernel-1)//2·dil on both sides and
    rhs dilation ``dil``, as one product over the stacked shifted views."""
    kernel, d_in, d_out = w.shape
    pad = (kernel - 1) // 2 * dil
    t_out = x.shape[1] + 2 * pad - (kernel - 1) * dil
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    cols = torch.cat([xp[:, k * dil: k * dil + t_out] for k in range(kernel)], dim=-1)
    return linear(cols, w.reshape(kernel * d_in, d_out), compute_dtype) + b


class TDNNStack(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 dilations: Sequence[int] = (1, 1, 3, 3, 3), kernel: int = 3,
                 dropout: float = 0.0, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.dilations = tuple(dilations)
        self.kernel = kernel
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.output_size = hidden_size
        self.layers = nn.ModuleList(
            TDNNLayer(kernel, input_size if i == 0 else hidden_size, hidden_size, generator)
            for i in range(len(self.dilations)))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x [B, T, D], mask [B, T] → [B, T, hidden] fp32."""
        m = None if mask is None else mask[..., None].to(torch.float32)
        last = len(self.dilations) - 1
        for i, (lp, dil) in enumerate(zip(self.layers, self.dilations)):
            if m is not None:
                x = x * m
            y = torch.relu(dilated_conv(x, lp.w, lp.b, dil, self.compute_dtype))
            y = layer_norm(y, lp.ln_scale, lp.ln_bias)
            if train and self.dropout > 0.0 and i < last:
                y = dropout(y, self.dropout, generator)
            x = y
        return x
