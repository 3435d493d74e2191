"""The device search's frontier, one frame: kernel K12 (``csrc/search.cu``)
and its plain version.

``frontier(g, tabs, alpha, obs_t, slot_prev, num_frames, t, k, beam,
lattice_beam)`` computes the first half of ``_Search.frame``
(decode/device_lattice.py) for a batch of B utterances over a
``DeviceDecodeGraph`` of S states: the in-arc relaxation of ``alpha`` [B, S]
over both degree buckets, the observation add (``obs_t`` [B, P]), the
in-frame eps layers, the exact top K (``lax.top_k``'s values and indices),
the keep and emit masks, the pruned next alpha and each emitted state's
frontier position. Rows whose utterance ended before frame ``t`` keep
``alpha`` and ``slot_prev``. ``frontier_plain`` is the same function in
PyTorch. The wrapper takes the plain version only for CPU tensors; on CUDA
tensors it launches K12 or raises, and ``frontier.launches`` counts the
launches. K12 reads ``tabs = frontier_tables(g)``: the graph's tables as
int32 and fp32, transposed to [d, S], made once per search.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pykaldi2_tpu_torch import device as D
from pykaldi2_tpu_torch.ops.fb import NEG_INF

Tensor = torch.Tensor
_HALF_NEG = 0.5 * NEG_INF


class Frontier(NamedTuple):
    obs_s: Tensor       # [B, S] fp32: obs_t at each state's pdf
    vals: Tensor        # [B, K] fp32: the top K scores, best first
    idx: Tensor         # [B, K] int64: their states
    keep_k: Tensor      # [B, K] bool: within beam of the best (and alive)
    emit_k: Tensor      # [B, K] bool: kept and within lattice_beam
    alpha_next: Tensor  # [B, S] fp32: the next frame's alpha
    slot_cur: Tensor    # [B, S] int64: frontier position of an emitted state, else -1


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def relax(g, al: Tensor):
    """[B, S] scores → the two buckets' in-arc relaxations [B, S1, d_lo] and
    [B, S2, d_hi] (None when the high bucket is empty)."""
    b, s1, s2 = al.shape[0], g.s_lo, g.num_states - g.s_lo
    r_lo = torch.clamp_min(al.index_select(1, g.in_src_lo.reshape(-1)).view(b, s1, g.d_lo)
                           + g.in_w_lo, NEG_INF)
    if not s2:
        return r_lo, None
    r_hi = torch.clamp_min(al.index_select(1, g.in_src_hi.reshape(-1)).view(b, s2, g.d_hi)
                           + g.in_w_hi, NEG_INF)
    return r_lo, r_hi


def eps_layer(g, al: Tensor, r: int) -> Tensor:
    """Topo layer r of the in-frame eps closure: each eps destination of
    depth r + 1 takes the max of its eps in-arcs from closed sources."""
    b = al.shape[0]
    for z, zsrc, zw, layers in ((g.eps_z1, g.eps_src_z1, g.eps_w_z1, g.eps_layers_z1),
                                (g.eps_z2, g.eps_src_z2, g.eps_w_z2, g.eps_layers_z2),
                                (g.eps_z3, g.eps_src_z3, g.eps_w_z3, g.eps_layers_z3)):
        if not z.shape[0]:
            continue
        lo, hi = layers[r], layers[r + 1]
        if hi > lo:
            e = zsrc.shape[1]
            rz = (al.index_select(1, zsrc[lo:hi].reshape(-1)).view(b, hi - lo, e)
                  + zw[lo:hi]).amax(dim=2)
            al = al.scatter_reduce(1, z[lo:hi].expand(b, hi - lo), rz, "amax")
    return al


def _order_key(x: Tensor) -> Tensor:
    """fp32 → int64 key, ascending exactly as the float total order
    (−0.0 below +0.0): the reference's monotone int32 key."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)


def _frontier_top_k(new_alpha: Tensor, k: int):
    """Exact top-K over [B, S]: ``lax.top_k``'s values and indices, ties to
    the lowest index in the float total order. One ``torch.topk`` over
    distinct int64 keys (the score's order key, complemented, above the
    state index), so the result does not depend on topk's tie handling."""
    s = new_alpha.shape[1]
    idx = torch.arange(s, device=new_alpha.device, dtype=torch.int64)
    key = (~_order_key(new_alpha)) * (1 << 32) + idx
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return new_alpha.gather(1, idx), idx


def frontier_plain(g, alpha: Tensor, obs_t: Tensor, slot_prev: Tensor, num_frames: Tensor,
                   t: int, k: int, beam: float, lattice_beam: float) -> Frontier:
    """K12's function in plain PyTorch (``frontier``'s contract)."""
    b = alpha.shape[0]
    r_lo, r_hi = relax(g, alpha)
    m = r_lo.amax(dim=2)
    if r_hi is not None:
        m = torch.cat([m, r_hi.amax(dim=2)], dim=1)
    obs_s = obs_t.index_select(1, g.state_pdf)                       # [B, S]
    new_alpha = torch.where(m > _HALF_NEG, m + obs_s, NEG_INF)
    for r in range(g.eps_depth):
        new_alpha = eps_layer(g, new_alpha, r)
    best = new_alpha.amax(dim=1)
    vals, idx = _frontier_top_k(new_alpha, k)                        # [B, K]
    # the search frontier shapes alpha; lattice nodes are the frontier
    # states within lattice_beam of the frame's best
    keep_k = (vals >= best[:, None] - beam) & (vals > _HALF_NEG)
    emit_k = keep_k & (vals >= best[:, None] - lattice_beam)
    cutoff = torch.maximum(best - beam, torch.where(keep_k[:, k - 1], vals[:, k - 1],
                                                    best - beam))[:, None]
    alpha_next = torch.where(new_alpha >= cutoff, new_alpha, NEG_INF)
    slot_ids = torch.arange(k, device=alpha.device).expand(b, k)
    slot_cur = torch.full_like(slot_prev, -1).scatter_reduce(
        1, idx, torch.where(emit_k, slot_ids, -1), "amax")
    active = (t < num_frames)[:, None]
    return Frontier(obs_s, vals, idx, keep_k, emit_k, torch.where(active, alpha_next, alpha),
                    torch.where(active, slot_cur, slot_prev))


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------


class FrontierTables(NamedTuple):
    """A ``DeviceDecodeGraph``'s tables as K12 reads them: int32 indices,
    fp32 scores, in-arc tables transposed to [d, rows]."""

    lo_src: Tensor    # [d_lo, S1]
    lo_w: Tensor
    hi_src: Tensor    # [d_hi, S2]
    hi_w: Tensor
    pdf: Tensor       # [S]
    ez: tuple         # three eps buckets: destinations [Z]
    esrc: tuple       # [e, Z]
    ew: tuple         # [e, Z]
    elayers: Tensor   # [3, L + 1] row offsets of each layer (one 0 when L = 0)


def frontier_tables(g) -> FrontierTables:
    """K12's tables of ``g``, on g's device."""
    i32 = torch.int32

    def tr(x, dtype):
        return x.t().to(dtype).contiguous()

    buckets = ((g.eps_z1, g.eps_src_z1, g.eps_w_z1), (g.eps_z2, g.eps_src_z2, g.eps_w_z2),
               (g.eps_z3, g.eps_src_z3, g.eps_w_z3))
    if g.eps_depth:
        layers = torch.tensor([g.eps_layers_z1, g.eps_layers_z2, g.eps_layers_z3], dtype=i32)
    else:
        layers = torch.zeros(1, dtype=i32)
    return FrontierTables(
        lo_src=tr(g.in_src_lo, i32), lo_w=tr(g.in_w_lo, torch.float32),
        hi_src=tr(g.in_src_hi, i32), hi_w=tr(g.in_w_hi, torch.float32),
        pdf=g.state_pdf.to(i32).contiguous(),
        ez=tuple(z.to(i32).contiguous() for z, _, _ in buckets),
        esrc=tuple(tr(s, i32) for _, s, _ in buckets),
        ew=tuple(tr(w, torch.float32) for _, _, w in buckets),
        elayers=layers.to(g.state_pdf.device))


# K12's shared memory: its C side refuses a launch whose layout differs
MAX_SMEM = 232448
FIXED_SMEM = (256 + 2 * 32 + 16) * 4


def smem_plan(s: int, k: int, limit: int = MAX_SMEM):
    """(rows in shared memory, sort buffer in shared memory, bytes, N) of a
    frame over S states at K: the two [S] rows first (they take the S x Dc
    gathers), then the [N] sort buffer (N the power of two at or above
    max(K, 32)); what does not fit is read from global memory."""
    n = max(32, 1 << max(k - 1, 0).bit_length())
    rows = 8 * s
    row_smem = FIXED_SMEM + rows <= limit
    used = FIXED_SMEM + (rows if row_smem else 0)
    sort_smem = used + 8 * n <= limit
    return row_smem, sort_smem, used + (8 * n if sort_smem else 0), n


_P = ctypes.c_void_p


class _Args(ctypes.Structure):
    """``FrontierArgs`` of csrc/search.cu, field for field."""

    _fields_ = ([(n, _P) for n in ("alpha", "slot_prev", "obs", "num_frames", "lo_src", "lo_w",
                                   "hi_src", "hi_w", "pdf")]
                + [("ez", _P * 3), ("esrc", _P * 3), ("ew", _P * 3), ("elayers", _P)]
                + [(n, _P) for n in ("obs_s", "vals", "idx", "keep", "emit", "alpha_next",
                                     "slot_cur", "scratch")]
                + [("obs_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("B", "S", "s_lo", "d_lo", "d_hi", "K", "N", "L",
                                               "t")]
                + [("ez_n", ctypes.c_int * 3), ("ee", ctypes.c_int * 3)]
                + [(n, ctypes.c_int) for n in ("row_smem", "sort_smem")]
                + [(n, ctypes.c_float) for n in ("beam", "lattice_beam", "neg_inf",
                                                 "half_neg")])


def _lib() -> ctypes.CDLL:
    lib = D.load_kernel_lib("search")
    if not getattr(lib, "_pk2_typed", False):
        lib.pk2_search_frontier.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, _P]
        lib.pk2_search_frontier.restype = ctypes.c_int
        for fn in ("pk2_search_max_smem", "pk2_search_fixed_smem", "pk2_search_args_size"):
            getattr(lib, fn).restype = ctypes.c_int
        if (lib.pk2_search_max_smem(), lib.pk2_search_fixed_smem(),
                lib.pk2_search_args_size()) != (MAX_SMEM, FIXED_SMEM, ctypes.sizeof(_Args)):
            raise RuntimeError("csrc/search.cu's layout differs from decode/frontier.py's")
        lib._pk2_typed = True
    return lib


def _check(name: str, x: Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, K12 takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(g, tabs: FrontierTables, dev: torch.device) -> None:
    s, s1 = g.num_states, g.s_lo
    i32, f32 = torch.int32, torch.float32
    for name, x, dtype, shape in (
            ("lo_src", tabs.lo_src, i32, (g.d_lo, s1)), ("lo_w", tabs.lo_w, f32, (g.d_lo, s1)),
            ("hi_src", tabs.hi_src, i32, (g.d_hi, s - s1)),
            ("hi_w", tabs.hi_w, f32, (g.d_hi, s - s1)), ("pdf", tabs.pdf, i32, (s,)),
            ("elayers", tabs.elayers, i32,
             (3, g.eps_depth + 1) if g.eps_depth else (1,))):
        _check(f"tables.{name}", x, dtype, shape, dev)
    for j in range(3):
        e, z = tabs.esrc[j].shape
        _check(f"tables.ez[{j}]", tabs.ez[j], i32, (z,), dev)
        _check(f"tables.esrc[{j}]", tabs.esrc[j], i32, (e, z), dev)
        _check(f"tables.ew[{j}]", tabs.ew[j], f32, (e, z), dev)


def takes_kernel(dev: torch.device) -> bool:
    """Whether ``frontier`` launches K12 on ``dev``'s tensors: on every
    device but the CPU."""
    return dev.type != "cpu"


def frontier(g, tabs: FrontierTables, alpha: Tensor, obs_t: Tensor, slot_prev: Tensor,
             num_frames: Tensor, t: int, k: int, beam: float, lattice_beam: float) -> Frontier:
    """K12: one frame's frontier (module docstring). ``alpha`` [B, S] fp32,
    ``slot_prev`` [B, S] int64, ``obs_t`` [B, P] fp32 with unit column
    stride, ``num_frames`` [B] int64, 1 <= k <= S."""
    if not takes_kernel(alpha.device):
        return frontier_plain(g, alpha, obs_t, slot_prev, num_frames, t, k, beam, lattice_beam)
    return _launch(g, tabs, alpha, obs_t, slot_prev, num_frames, t, k, beam, lattice_beam)


def _launch(g, tabs: FrontierTables, alpha: Tensor, obs_t: Tensor, slot_prev: Tensor,
            num_frames: Tensor, t: int, k: int, beam: float, lattice_beam: float) -> Frontier:
    dev = alpha.device
    if alpha.dim() != 2:
        raise ValueError(f"alpha must be [B, S], got {tuple(alpha.shape)}")
    b, s = alpha.shape
    if s != g.num_states or not 1 <= k <= s:
        raise ValueError(f"K12 takes [B, {g.num_states}] rows and 1 <= K <= S, got "
                         f"{tuple(alpha.shape)} and K={k}")
    _check("alpha", alpha, torch.float32, (b, s), dev)
    _check("slot_prev", slot_prev, torch.int64, (b, s), dev)
    _check("num_frames", num_frames, torch.int64, (b,), dev)
    if obs_t.device != dev or obs_t.dtype != torch.float32 or obs_t.dim() != 2 \
            or obs_t.shape[0] != b or obs_t.stride(1) != 1:
        raise ValueError(f"obs_t must be [{b}, P] fp32 on {dev} with unit column stride, got "
                         f"{tuple(obs_t.shape)} {obs_t.dtype} on {obs_t.device}")
    _check_tables(g, tabs, dev)
    row_smem, sort_smem, smem, n = smem_plan(s, k)
    out = Frontier(obs_s=torch.empty(b, s, dtype=torch.float32, device=dev),
                   vals=torch.empty(b, k, dtype=torch.float32, device=dev),
                   idx=torch.empty(b, k, dtype=torch.int64, device=dev),
                   keep_k=torch.empty(b, k, dtype=torch.bool, device=dev),
                   emit_k=torch.empty(b, k, dtype=torch.bool, device=dev),
                   alpha_next=torch.empty(b, s, dtype=torch.float32, device=dev),
                   slot_cur=torch.empty(b, s, dtype=torch.int64, device=dev))
    scratch = None if sort_smem else torch.empty(b, n, dtype=torch.int64, device=dev)
    a = _Args(alpha=alpha.data_ptr(), slot_prev=slot_prev.data_ptr(), obs=obs_t.data_ptr(),
              num_frames=num_frames.data_ptr(), lo_src=tabs.lo_src.data_ptr(),
              lo_w=tabs.lo_w.data_ptr(), hi_src=tabs.hi_src.data_ptr(),
              hi_w=tabs.hi_w.data_ptr(), pdf=tabs.pdf.data_ptr(),
              ez=(_P * 3)(*(x.data_ptr() for x in tabs.ez)),
              esrc=(_P * 3)(*(x.data_ptr() for x in tabs.esrc)),
              ew=(_P * 3)(*(x.data_ptr() for x in tabs.ew)), elayers=tabs.elayers.data_ptr(),
              obs_s=out.obs_s.data_ptr(), vals=out.vals.data_ptr(), idx=out.idx.data_ptr(),
              keep=out.keep_k.data_ptr(), emit=out.emit_k.data_ptr(),
              alpha_next=out.alpha_next.data_ptr(), slot_cur=out.slot_cur.data_ptr(),
              scratch=0 if scratch is None else scratch.data_ptr(),
              obs_stride=obs_t.stride(0), B=b, S=s, s_lo=g.s_lo, d_lo=g.d_lo, d_hi=g.d_hi, K=k,
              N=n, L=g.eps_depth, t=t, ez_n=(ctypes.c_int * 3)(*(x.shape[0] for x in tabs.ez)),
              ee=(ctypes.c_int * 3)(*(x.shape[0] for x in tabs.esrc)), row_smem=row_smem,
              sort_smem=sort_smem, beam=beam, lattice_beam=lattice_beam, neg_inf=NEG_INF,
              half_neg=_HALF_NEG)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.pk2_search_frontier(ctypes.byref(a), smem, D.current_stream_ptr(dev))
    D.check_launch(rc, "search frontier (K12)")
    frontier.launches += 1
    return out


frontier.launches = 0
