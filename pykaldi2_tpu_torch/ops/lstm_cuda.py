"""LSTM recurrence: kernels K2/K3 and K5/K6 (``csrc/lstm.cu``), plain
versions, autograd.

Counterpart of pykaldi2_tpu/ops/lstm_pallas.py. Replaces ``_fwd_kernel``
(K2) and ``_bwd_kernel`` (K3): per step, gates = xp_t + h·Wh with bf16
operands and an fp32 sum, sigmoid/tanh gates, an fp32 cell, and a masked
carry (padded frames keep their state, which also makes the reversed
direction right for right-padded batches); the backward runs in reverse
time and emits the pre-activation gate gradients. dWh is one bf16 GEMM
outside the kernels, as in the reference (lstm_pallas.py:318-325).

K5/K6 replace ``_fwd_proj_kernel`` and ``_bwd_proj_kernel``, the projected
LSTM (LSTMP, lstm_pallas.py:384-599): the recurrence reads hp = bf16(h_full)
·Wp [B, P] and Wh is [P, 4H]; the masked carry is on hp and c. The forward
also saves h_full in bf16; the backward also emits the masked dhp. dWh =
Σ hp_{t-1}ᵀ·dgates and dWp = Σ h_fullᵀ·dhp_m are two bf16 GEMMs with fp32
results outside the kernels (lstm_pallas.py:580-593).

On the H100 the kernels are bound by the per-step latency of exchanging the
new state across the grid, not by bytes or flops; see the note at the top of
``csrc/lstm.cu`` for the persistent designs (Wh slices resident in shared
memory, mma.sync, one grid barrier per step, two for K5/K6; K2, K3 and K6
split each step's product over a thread-block cluster and sum the partials
in distributed shared memory). ``lstm_clusters`` reports the cluster sizes
K2/K3 launch with, ``lstmp_bwd_cluster`` K6's.

Streams stay fp32 at every size: the JAX package's bf16 stream modes
(``_stream_dtype``, ``_stream_dtype_proj``) and its batch tiling
(``_tile_b_proj``) existed only for the TPU's VMEM budget. ``gates`` (and
``hfull``) are kept in bf16 for the backward, as in the reference.

Each wrapper takes the plain version only for CPU tensors; on CUDA tensors
it launches its kernel or raises. ``lstm_fwd.launches``,
``lstm_bwd.launches``, ``lstm_proj_fwd.launches`` and
``lstm_proj_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pykaldi2_tpu_torch import device as D

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# bf16 products with an fp32 result
# ---------------------------------------------------------------------------


def mm_bf16(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with both operands rounded to bf16, summed and returned in fp32
    (the reference's ``preferred_element_type=float32`` products).

    On the CPU the rounded operands are multiplied in fp32, which is exact
    for bf16 products. On CUDA it is one cuBLAS bf16 GEMM with an fp32
    output (``torch.mm`` with ``out_dtype``)."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


class MatmulBf16(torch.autograd.Function):
    """x [N, K] @ w [K, M] through ``mm_bf16``; gradients are bf16 products
    with fp32 results too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_bf16(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = mm_bf16(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = mm_bf16(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def linear(x: Tensor, w: Tensor, compute_dtype: torch.dtype) -> Tensor:
    """x [..., K] @ w [K, M] → fp32 [..., M]; bf16 operands when
    ``compute_dtype`` is bfloat16, plain fp32 otherwise."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if compute_dtype == torch.bfloat16:
        out = MatmulBf16.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# plain versions (the same arithmetic as the kernels, in torch)
# ---------------------------------------------------------------------------


def lstm_fwd_plain(xp: Tensor, wh_b: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """xp [T,B,4H] f32, wh_b [H,4H] bf16, mask [T,B] f32 → ys, cs [T,B,H] f32,
    gates [T,B,4H] bf16 (activated i, f, g, o)."""
    t_len, b, h4 = xp.shape
    h = h4 // 4
    whf = wh_b.float()
    hs = xp.new_zeros(b, h)
    c = xp.new_zeros(b, h)
    ys, cs, gates = [], [], []
    for t in range(t_len):
        pre = xp[t] + hs.to(torch.bfloat16).float() @ whf
        i = torch.sigmoid(pre[:, :h])
        f = torch.sigmoid(pre[:, h:2 * h])
        g = torch.tanh(pre[:, 2 * h:3 * h])
        o = torch.sigmoid(pre[:, 3 * h:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        hs = m * h_new + (1.0 - m) * hs
        c = m * c_new + (1.0 - m) * c
        ys.append(hs)
        cs.append(c)
        gates.append(torch.cat([i, f, g, o], dim=-1).to(torch.bfloat16))
    return torch.stack(ys), torch.stack(cs), torch.stack(gates)


def lstm_bwd_plain(dys: Tensor, gates: Tensor, cs: Tensor, mask: Tensor,
                   wh_b: Tensor) -> Tensor:
    """dys [T,B,H] f32, gates [T,B,4H] bf16, cs [T,B,H] f32, mask [T,B],
    wh_b [H,4H] bf16 → dgates [T,B,4H] f32 (pre-activation gate gradients)."""
    t_len, b, h = dys.shape
    whT = wh_b.float().t()
    dh_s = dys.new_zeros(b, h)
    dc_s = dys.new_zeros(b, h)
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        m = mask[t][:, None]
        dh_total = dh_s + dys[t]
        dc_in = dc_s
        gt = gates[t].float()
        i, f, g, o = gt[:, :h], gt[:, h:2 * h], gt[:, 2 * h:3 * h], gt[:, 3 * h:]
        c = cs[t]
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(c)
        tanh_c = torch.tanh(c)
        dh_m = m * dh_total
        do = dh_m * tanh_c
        dc = dh_m * o * (1.0 - tanh_c * tanh_c) + m * dc_in
        di, df, dg = dc * g, dc * c_prev, dc * i
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        out[t] = dgates
        dh_rec = dgates.to(torch.bfloat16).float() @ whT
        dh_s = dh_rec + (1.0 - m) * dh_total
        dc_s = dc * f + (1.0 - m) * dc_in
    return torch.stack(out)


def lstm_proj_fwd_plain(xp: Tensor, wh_b: Tensor, wp_b: Tensor, mask: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """xp [T,B,4H] f32, wh_b [P,4H] bf16, wp_b [H,P] bf16, mask [T,B] f32 →
    ys [T,B,P] f32 (hp), cs [T,B,H] f32, gates [T,B,4H] bf16 (activated
    i, f, g, o), hfull [T,B,H] bf16 (the unmasked h_full)."""
    t_len, b, h4 = xp.shape
    h = h4 // 4
    whf, wpf = wh_b.float(), wp_b.float()
    hp = xp.new_zeros(b, wh_b.shape[0])
    c = xp.new_zeros(b, h)
    ys, cs, gates, hfull = [], [], [], []
    for t in range(t_len):
        pre = xp[t] + hp.to(torch.bfloat16).float() @ whf
        i = torch.sigmoid(pre[:, :h])
        f = torch.sigmoid(pre[:, h:2 * h])
        g = torch.tanh(pre[:, 2 * h:3 * h])
        o = torch.sigmoid(pre[:, 3 * h:])
        c_new = f * c + i * g
        h_full = o * torch.tanh(c_new)
        proj = h_full.to(torch.bfloat16).float() @ wpf
        m = mask[t][:, None]
        hp = m * proj + (1.0 - m) * hp
        c = m * c_new + (1.0 - m) * c
        ys.append(hp)
        cs.append(c)
        gates.append(torch.cat([i, f, g, o], dim=-1).to(torch.bfloat16))
        hfull.append(h_full.to(torch.bfloat16))
    return torch.stack(ys), torch.stack(cs), torch.stack(gates), torch.stack(hfull)


def lstm_proj_bwd_plain(dys: Tensor, gates: Tensor, cs: Tensor, mask: Tensor,
                        wh_b: Tensor, wp_b: Tensor) -> Tuple[Tensor, Tensor]:
    """dys [T,B,P] f32, gates [T,B,4H] bf16, cs [T,B,H] f32, mask [T,B],
    wh_b [P,4H] bf16, wp_b [H,P] bf16 → dgates [T,B,4H] f32 (pre-activation
    gate gradients), dhpm [T,B,P] f32 (the masked dhp, for dWp)."""
    t_len, b, p = dys.shape
    h = cs.shape[-1]
    whT, wpT = wh_b.float().t(), wp_b.float().t()
    dhp_s = dys.new_zeros(b, p)
    dc_s = dys.new_zeros(b, h)
    out, out_m = [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1):
        m = mask[t][:, None]
        dhp_total = dhp_s + dys[t]
        dhp_m = m * dhp_total
        dc_in = dc_s
        dh_full = dhp_m.to(torch.bfloat16).float() @ wpT
        gt = gates[t].float()
        i, f, g, o = gt[:, :h], gt[:, h:2 * h], gt[:, 2 * h:3 * h], gt[:, 3 * h:]
        c = cs[t]
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(c)
        tanh_c = torch.tanh(c)
        do = dh_full * tanh_c
        dc = dh_full * o * (1.0 - tanh_c * tanh_c) + m * dc_in
        di, df, dg = dc * g, dc * c_prev, dc * i
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        out[t], out_m[t] = dgates, dhp_m
        dhp_rec = dgates.to(torch.bfloat16).float() @ whT
        dhp_s = dhp_rec + (1.0 - m) * dhp_total
        dc_s = dc * f + (1.0 - m) * dc_in
    return torch.stack(out), torch.stack(out_m)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = D.load_kernel_lib("lstm")
    if not getattr(lib, "_pk2_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pk2_lstm_fwd.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.pk2_lstm_fwd.restype = ci
        lib.pk2_lstm_bwd.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.pk2_lstm_bwd.restype = ci
        lib.pk2_lstm_max_batch.argtypes = []
        lib.pk2_lstm_max_batch.restype = ci
        lib.pk2_lstm_clusters.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.pk2_lstm_clusters.restype = ci
        lib.pk2_lstmp_fwd.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.pk2_lstmp_fwd.restype = ci
        lib.pk2_lstmp_bwd.argtypes = [vp] * 10 + [ci] * 5 + [vp]
        lib.pk2_lstmp_bwd.restype = ci
        lib.pk2_lstmp_bwd_cluster.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.pk2_lstmp_bwd_cluster.restype = ci
        lib._pk2_typed = True
    return lib


def _check(name: str, t: Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_hidden(h: int):
    # the kernels' CTAs (H/8 or H/16) must be co-resident, and one CTA's
    # shared memory holds its Wh slice plus a 64-row staging buffer: both cap
    # H at 1024
    if h < 16 or h % 16 or h > 1024:
        raise ValueError(f"LSTM kernels take a hidden size that is a multiple of 16 "
                         f"and at most 1024, got {h}")


def lstm_clusters(h: int, dev: torch.device) -> Tuple[int, int]:
    """The thread-block cluster sizes K2 and K3 launch with at hidden size
    ``h`` on ``dev`` (0: the clusters do not fit on the card at once)."""
    _check_hidden(h)
    lib = _lib()
    k2, k3 = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        D.check_launch(lib.pk2_lstm_clusters(h, ctypes.byref(k2), ctypes.byref(k3)),
                       "LSTM cluster query")
    return k2.value, k3.value


def lstmp_bwd_cluster(h: int, p: int, dev: torch.device) -> int:
    """The thread-block cluster size K6 launches with at hidden size ``h``
    and projection ``p`` on ``dev`` (0: no cluster size fits)."""
    _check_proj(h, p)
    lib = _lib()
    c = ctypes.c_int(0)
    with torch.cuda.device(dev):
        D.check_launch(lib.pk2_lstmp_bwd_cluster(h, p, ctypes.byref(c)), "K6 cluster query")
    return c.value


def lstm_fwd(xp: Tensor, wh_b: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K2. Same contract as ``lstm_fwd_plain``."""
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, wh_b, mask)
    t_len, b, h4 = xp.shape
    h = h4 // 4
    dev = xp.device
    _check("xp", xp, torch.float32, (t_len, b, h4), dev)
    _check("wh", wh_b, torch.bfloat16, (h, h4), dev)
    _check("mask", mask, torch.float32, (t_len, b), dev)
    _check_hidden(h)
    lib = _lib()
    ys = torch.empty((t_len, b, h), dtype=torch.float32, device=dev)
    cs = torch.empty_like(ys)
    gates = torch.empty((t_len, b, h4), dtype=torch.bfloat16, device=dev)
    max_b = lib.pk2_lstm_max_batch()
    with torch.cuda.device(dev):
        stream = D.current_stream_ptr(dev)
        for b0 in range(0, b, max_b):
            nb = min(max_b, b - b0)
            hbuf = torch.empty((2, nb, h), dtype=torch.bfloat16, device=dev)
            rc = lib.pk2_lstm_fwd(
                ctypes.c_void_p(xp.data_ptr() + b0 * h4 * 4), D.ptr(wh_b),
                ctypes.c_void_p(mask.data_ptr() + b0 * 4),
                ctypes.c_void_p(ys.data_ptr() + b0 * h * 4),
                ctypes.c_void_p(cs.data_ptr() + b0 * h * 4),
                ctypes.c_void_p(gates.data_ptr() + b0 * h4 * 2), D.ptr(hbuf),
                t_len, nb, b, h, stream)
            D.check_launch(rc, "LSTM forward kernel (K2)")
            lstm_fwd.launches += 1
    return ys, cs, gates


lstm_fwd.launches = 0


def lstm_bwd(dys: Tensor, gates: Tensor, cs: Tensor, mask: Tensor, wh_b: Tensor) -> Tensor:
    """K3. Same contract as ``lstm_bwd_plain``."""
    if dys.device.type == "cpu":
        return lstm_bwd_plain(dys, gates, cs, mask, wh_b)
    t_len, b, h = dys.shape
    h4 = 4 * h
    dev = dys.device
    _check("dys", dys, torch.float32, (t_len, b, h), dev)
    _check("gates", gates, torch.bfloat16, (t_len, b, h4), dev)
    _check("cs", cs, torch.float32, (t_len, b, h), dev)
    _check("mask", mask, torch.float32, (t_len, b), dev)
    _check("wh", wh_b, torch.bfloat16, (h, h4), dev)
    _check_hidden(h)
    lib = _lib()
    dgates = torch.empty((t_len, b, h4), dtype=torch.float32, device=dev)
    max_b = lib.pk2_lstm_max_batch()
    with torch.cuda.device(dev):
        stream = D.current_stream_ptr(dev)
        for b0 in range(0, b, max_b):
            nb = min(max_b, b - b0)
            dgbuf = torch.empty((2, nb, h4), dtype=torch.bfloat16, device=dev)
            rc = lib.pk2_lstm_bwd(
                ctypes.c_void_p(dys.data_ptr() + b0 * h * 4),
                ctypes.c_void_p(gates.data_ptr() + b0 * h4 * 2),
                ctypes.c_void_p(cs.data_ptr() + b0 * h * 4),
                ctypes.c_void_p(mask.data_ptr() + b0 * 4), D.ptr(wh_b),
                ctypes.c_void_p(dgates.data_ptr() + b0 * h4 * 4), D.ptr(dgbuf),
                t_len, nb, b, h, stream)
            D.check_launch(rc, "LSTM backward kernel (K3)")
            lstm_bwd.launches += 1
    return dgates


lstm_bwd.launches = 0


def _check_proj(h: int, p: int):
    # the LSTM kernels' limit on H, and P columns in 16-wide k-steps; P <= H
    # keeps the P/8 projection column groups within the H/8 CTAs, and the
    # shared memory of the weight slices and the staged state within a block's
    # 227 KB up to H = P = 1024
    _check_hidden(h)
    if p < 16 or p % 16 or p > h:
        raise ValueError(f"LSTMP kernels take a projection size that is a multiple of 16 "
                         f"and at most the hidden size {h}, got {p}")


def _off(t: Tensor, elems: int) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() + elems * t.element_size())


def lstm_proj_fwd(xp: Tensor, wh_b: Tensor, wp_b: Tensor, mask: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K5. Same contract as ``lstm_proj_fwd_plain``."""
    if xp.device.type == "cpu":
        return lstm_proj_fwd_plain(xp, wh_b, wp_b, mask)
    t_len, b, h4 = xp.shape
    h, p = h4 // 4, wh_b.shape[0]
    dev = xp.device
    _check("xp", xp, torch.float32, (t_len, b, h4), dev)
    _check("wh", wh_b, torch.bfloat16, (p, h4), dev)
    _check("wp", wp_b, torch.bfloat16, (h, p), dev)
    _check("mask", mask, torch.float32, (t_len, b), dev)
    _check_proj(h, p)
    lib = _lib()
    ys = torch.empty((t_len, b, p), dtype=torch.float32, device=dev)
    cs = torch.empty((t_len, b, h), dtype=torch.float32, device=dev)
    gates = torch.empty((t_len, b, h4), dtype=torch.bfloat16, device=dev)
    hfull = torch.empty((t_len, b, h), dtype=torch.bfloat16, device=dev)
    max_b = lib.pk2_lstm_max_batch()
    with torch.cuda.device(dev):
        stream = D.current_stream_ptr(dev)
        for b0 in range(0, b, max_b):
            nb = min(max_b, b - b0)
            hpbuf = torch.empty((nb, p), dtype=torch.bfloat16, device=dev)
            rc = lib.pk2_lstmp_fwd(
                _off(xp, b0 * h4), D.ptr(wh_b), D.ptr(wp_b), _off(mask, b0), _off(ys, b0 * p),
                _off(cs, b0 * h), _off(gates, b0 * h4), _off(hfull, b0 * h), D.ptr(hpbuf),
                t_len, nb, b, h, p, stream)
            D.check_launch(rc, "LSTMP forward kernel (K5)")
            lstm_proj_fwd.launches += 1
    return ys, cs, gates, hfull


lstm_proj_fwd.launches = 0


def lstm_proj_bwd(dys: Tensor, gates: Tensor, cs: Tensor, mask: Tensor, wh_b: Tensor,
                  wp_b: Tensor) -> Tuple[Tensor, Tensor]:
    """K6. Same contract as ``lstm_proj_bwd_plain``."""
    if dys.device.type == "cpu":
        return lstm_proj_bwd_plain(dys, gates, cs, mask, wh_b, wp_b)
    t_len, b, p = dys.shape
    h = cs.shape[-1]
    h4 = 4 * h
    dev = dys.device
    _check("dys", dys, torch.float32, (t_len, b, p), dev)
    _check("gates", gates, torch.bfloat16, (t_len, b, h4), dev)
    _check("cs", cs, torch.float32, (t_len, b, h), dev)
    _check("mask", mask, torch.float32, (t_len, b), dev)
    _check("wh", wh_b, torch.bfloat16, (p, h4), dev)
    _check("wp", wp_b, torch.bfloat16, (h, p), dev)
    _check_proj(h, p)
    lib = _lib()
    dgates = torch.empty((t_len, b, h4), dtype=torch.float32, device=dev)
    dhpm = torch.empty((t_len, b, p), dtype=torch.float32, device=dev)
    max_b = lib.pk2_lstm_max_batch()
    with torch.cuda.device(dev):
        stream = D.current_stream_ptr(dev)
        for b0 in range(0, b, max_b):
            nb = min(max_b, b - b0)
            dgbuf = torch.empty((nb, h4), dtype=torch.bfloat16, device=dev)
            dpbuf = torch.empty((nb, p), dtype=torch.bfloat16, device=dev)
            rc = lib.pk2_lstmp_bwd(
                _off(dys, b0 * p), _off(gates, b0 * h4), _off(cs, b0 * h), _off(mask, b0),
                D.ptr(wh_b), D.ptr(wp_b), _off(dgates, b0 * h4), _off(dhpm, b0 * p),
                D.ptr(dgbuf), D.ptr(dpbuf), t_len, nb, b, h, p, stream)
            D.check_launch(rc, "LSTMP backward kernel (K6)")
            lstm_proj_bwd.launches += 1
    return dgates, dhpm


lstm_proj_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class LstmSeq(torch.autograd.Function):
    """``LstmSeq.apply(xp, wh, mask) -> ys``: xp [T,B,4H] (input projections
    plus bias), wh [H,4H], mask [T,B] or [T,B,1] → ys [T,B,H]. Same contract
    as ``lstm_seq_pallas`` (lstm_pallas.py:296-330): Wh is rounded to bf16,
    gradients flow to xp (the gate gradients) and to wh."""

    @staticmethod
    def forward(ctx, xp, wh, mask):
        mask2 = mask.reshape(mask.shape[0], mask.shape[1]).to(torch.float32).contiguous()
        wh_b = wh.to(torch.bfloat16).contiguous()
        ys, cs, gates = lstm_fwd(xp.to(torch.float32).contiguous(), wh_b, mask2)
        ctx.save_for_backward(wh_b, mask2, ys, cs, gates)
        return ys

    @staticmethod
    def backward(ctx, dys):
        wh_b, mask2, ys, cs, gates = ctx.saved_tensors
        dgates = lstm_bwd(dys.to(torch.float32).contiguous(), gates, cs, mask2, wh_b)
        t_len, b, h = ys.shape
        dwh = None
        if ctx.needs_input_grad[1]:
            # dWh = sum_t h_{t-1}^T dgates_t: one bf16 GEMM with an fp32 result
            h_prev = torch.cat([ys.new_zeros(1, b, h), ys[:-1]], dim=0)
            dwh = mm_bf16(h_prev.reshape(-1, h).t(), dgates.reshape(-1, 4 * h))
        return dgates, dwh, None


class LstmProjSeq(torch.autograd.Function):
    """``LstmProjSeq.apply(xp, wh, wp, mask) -> ys``: xp [T,B,4H] (input
    projections plus bias), wh [P,4H], wp [H,P], mask [T,B] or [T,B,1] → ys
    [T,B,P] (the projected states). Same contract as ``lstm_seq_proj_pallas``
    (lstm_pallas.py:549-599): Wh and Wp are rounded to bf16, gradients flow
    to xp (the gate gradients), wh and wp."""

    @staticmethod
    def forward(ctx, xp, wh, wp, mask):
        mask2 = mask.reshape(mask.shape[0], mask.shape[1]).to(torch.float32).contiguous()
        wh_b = wh.to(torch.bfloat16).contiguous()
        wp_b = wp.to(torch.bfloat16).contiguous()
        ys, cs, gates, hfull = lstm_proj_fwd(xp.to(torch.float32).contiguous(), wh_b, wp_b,
                                             mask2)
        ctx.save_for_backward(wh_b, wp_b, mask2, ys, cs, gates, hfull)
        return ys

    @staticmethod
    def backward(ctx, dys):
        wh_b, wp_b, mask2, ys, cs, gates, hfull = ctx.saved_tensors
        dgates, dhpm = lstm_proj_bwd(dys.to(torch.float32).contiguous(), gates, cs, mask2,
                                     wh_b, wp_b)
        t_len, b, p = ys.shape
        h = cs.shape[-1]
        dwh = dwp = None
        if ctx.needs_input_grad[1]:
            # dWh = sum_t hp_{t-1}^T dgates_t
            hp_prev = torch.cat([ys.new_zeros(1, b, p), ys[:-1]], dim=0)
            dwh = mm_bf16(hp_prev.reshape(-1, p).t(), dgates.reshape(-1, 4 * h))
        if ctx.needs_input_grad[2]:
            # dWp = sum_t h_full_t^T dhp_m,t
            dwp = mm_bf16(hfull.reshape(-1, h).t(), dhpm.reshape(-1, p))
        return dgates, dwh, dwp, None
