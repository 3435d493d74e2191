"""Fused log-mel fbank and MFCC: kernels K1 and K4 (``csrc/fbank.cu``) and
their plain versions.

K1 replaces pykaldi2_tpu/frontend/fused.py:_kernel (the Pallas fused fbank,
called through ``fused_fbank``). Per frame row: DC removal over the real
window, pre-emphasis, window, real DFT as cos/sin products, power, mel
product, log with a FLT_EPSILON floor; dither must be 0 and the options the
standard log-power fbank without energy, as in the reference.

K4 replaces :_mfcc_kernel (called through ``fused_mfcc``): K1's steps, the
raw log-energy of each row (after DC removal, before pre-emphasis; floored
at FLT_EPSILON, then at log(energy_floor) when that is > 0), and the DCT
product with the lifter folded into the matrix; column 0 becomes the
log-energy when ``use_energy``. Dither must be 0. As in the reference, the
energy is always the raw one: ``FeaturePipeline`` sends ``use_energy`` with
``raw_energy`` false to ``compute_mfcc`` instead.

On the H100 the kernel is bound by fp32 FMA throughput (no TF32, no tensor
cores: the front end is fp32-exact); see the note at the top of
``csrc/fbank.cu`` for what its design does about it. Framing moved inside
the kernel: it computes each frame's sample indices as ``_frame_indices``
does (shift, offset, reflection at the ends) and reads the waveform (the
Mosaic limit that kept framing outside the TPU kernel does not apply).
The kernel takes its own tables (``_kernel_tables``, which depend on the
options only, not on the waveform's length): the window, one DFT table
whose columns interleave cos and -sin of each bin, padded with zeros, each
mel filter's weights over its run of nonzero bins (``mel_ranges``), the
only bins its mel product sums, and K4's lifted DCT. The per-length
constants (``_constants``) serve the plain versions only.

``fused_fbank`` and ``fused_mfcc`` take the plain version only for tensors
on the CPU; on a CUDA tensor they launch their kernel or raise.
``fused_fbank.launches`` and ``fused_mfcc.launches`` count kernel launches.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from pykaldi2_tpu_torch import device as D
from pykaldi2_tpu_torch.config import FbankOpts, MfccOpts
from pykaldi2_tpu_torch.frontend import window as W
from pykaldi2_tpu_torch.frontend.fbank import _dft_matrices
from pykaldi2_tpu_torch.frontend.mel import mel_banks
from pykaldi2_tpu_torch.frontend.mfcc import dct_matrix, lifter_coeffs


def _check_opts(opts: FbankOpts) -> None:
    if opts.frame_opts.dither != 0.0:
        raise ValueError("fused kernel expects dither pre-applied (or 0)")
    if opts.use_energy or not opts.use_log_fbank or not opts.use_power:
        raise ValueError("fused kernel covers the standard log-power fbank path")


def _opts_key(opts: FbankOpts) -> tuple:
    fo, mo = opts.frame_opts, opts.mel_opts
    return (fo.samp_freq, fo.frame_shift_ms, fo.frame_length_ms, fo.preemph_coeff,
            fo.remove_dc_offset, fo.window_type, fo.round_to_power_of_two,
            fo.blackman_coeff, fo.snip_edges, mo.num_bins, mo.low_freq, mo.high_freq,
            mo.vtln_warp, mo.vtln_low, mo.vtln_high)


_CONSTANTS: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _constants(opts: FbankOpts, n_samples: int, device: torch.device):
    """Device tensors the kernel reads: frame index table [T, W] int32,
    window [W], DFT tables restricted to the W real rows [W, K], and the
    transposed mel matrix [K, M]. Cached per (options, length, device)."""
    key = (_opts_key(opts), n_samples, str(device))
    hit = _CONSTANTS.get(key)
    if hit is not None:
        return hit
    fo = opts.frame_opts
    n_fft = fo.padded_window_size
    t_frames = W.num_frames(n_samples, fo)
    cos_m, sin_m = _dft_matrices(n_fft)
    win = fo.window_size

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    out = (put(W._frame_indices(n_samples, t_frames, fo), torch.int32),
           put(W.feature_window(fo)), put(cos_m[:win]), put(sin_m[:win]),
           put(mel_banks(opts.mel_opts, fo).T))
    _CONSTANTS[key] = out
    while len(_CONSTANTS) > 16:
        _CONSTANTS.popitem(last=False)
    return out


def mel_ranges(bank: np.ndarray) -> np.ndarray:
    """[M, 2] int32 (lo, hi): filter m's weights are zero outside bins
    [lo, hi), its first and last nonzero bin; (0, 0) for a filter with
    none. A sum over [lo, hi) in ascending k equals the dense one over all
    bins bit for bit: each skipped term is fmaf(x, 0, acc) == acc."""
    out = np.zeros((bank.shape[0], 2), np.int32)
    for m, row in enumerate(bank):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out


def kernel_table_shape(win: int, k: int) -> tuple:
    """(Wp, Kp): the DFT table's rows (the window rounded up to the
    kernel's chunk of 16 rows) and bins (K rounded up to a power of two, at
    least 32) as ``csrc/fbank.cu`` takes them."""
    return -(-win // 16) * 16, max(32, 1 << (k - 1).bit_length())


def _lifted_dct_t(opts: MfccOpts) -> np.ndarray:
    """The DCT matrix with the lifter folded in, transposed to [M, C]."""
    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)       # [C, M]
    if opts.cepstral_lifter != 0.0:
        dct = dct * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[:, None]
    return np.ascontiguousarray(dct.T)


_TABLES: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _kernel_tables(opts, device: torch.device):
    """The kernel's tables for FbankOpts (K1) or MfccOpts (K4): the window
    [W]; the interleaved DFT table [Wp, 2Kp] stored as [2Kp/64, Wp, 64]
    blocks of 64 columns (a ring stage of a block is one contiguous copy);
    the mel weights of each filter's run of bins (``mel_ranges``) one filter
    after another, and each filter's [lo, hi, offset into them] [M, 3]; K4's
    lifted DCT [M, C] (None for K1); and (Wp, Kp). None depends on the
    waveform's length: cached per (options, device), the least recently used
    dropped past 16."""
    mfcc = isinstance(opts, MfccOpts)
    fo = opts.frame_opts
    key = (_opts_key(FbankOpts(frame_opts=fo, mel_opts=opts.mel_opts)),
           (opts.num_ceps, opts.cepstral_lifter) if mfcc else None, str(device))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    cos_m, sin_m = _dft_matrices(fo.padded_window_size)
    win, k = fo.window_size, cos_m.shape[1]
    wp, kp = kernel_table_shape(win, k)
    cs = np.zeros((wp, kp, 2), np.float32)
    cs[:win, :k, 0] = cos_m[:win]
    cs[:win, :k, 1] = sin_m[:win]
    cs = cs.reshape(wp, 2 * kp // 64, 64).transpose(1, 0, 2)  # blocks of 64 columns
    bank = mel_banks(opts.mel_opts, fo)
    rng = mel_ranges(bank)
    weights = [row[lo:hi] for row, (lo, hi) in zip(bank, rng)]
    off = np.cumsum([0] + [len(x) for x in weights[:-1]])
    band = np.concatenate([rng, off[:, None]], axis=1).astype(np.int32)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    out = (put(W.feature_window(fo)), put(cs), put(np.concatenate(weights)),
           put(band, torch.int32), put(_lifted_dct_t(opts)) if mfcc else None, wp, kp)
    _TABLES[key] = out
    while len(_TABLES) > 16:
        _TABLES.popitem(last=False)
    return out


def _first_sample(fo) -> int:
    """Frame 0's first sample before reflection, as ``window._frame_indices``
    places it: frame t starts at t * shift + this."""
    return 0 if fo.snip_edges else fo.window_shift // 2 - fo.window_size // 2


def _centred_frames(wave: torch.Tensor, idx: torch.Tensor, fo) -> torch.Tensor:
    """[B, S] → [B, T, W] frames through the index table, DC removed."""
    frames = wave.to(torch.float32)[:, idx.long()]
    if fo.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    return frames


def _logmel(frames: torch.Tensor, fo, win, cos_w, sin_w, mel_t) -> torch.Tensor:
    """Centred frames → pre-emphasis, window, DFT, power, mel, log."""
    if fo.preemph_coeff != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - fo.preemph_coeff * prev
    x = frames * win
    re = x @ cos_w                                   # zero-padded tail adds nothing
    im = x @ sin_w
    mel = (re * re + im * im) @ mel_t
    return torch.log(torch.clamp(mel, min=W.FLT_EPSILON))


def fused_fbank_plain(wave: torch.Tensor, opts: FbankOpts) -> torch.Tensor:
    """Plain torch version of K1: the same steps on the same constants."""
    _check_opts(opts)
    idx, win, cos_w, sin_w, mel_t = _constants(opts, wave.shape[1], wave.device)
    frames = _centred_frames(wave, idx, opts.frame_opts)
    return _logmel(frames, opts.frame_opts, win, cos_w, sin_w, mel_t)


def fused_fbank(wave: torch.Tensor, opts: FbankOpts) -> torch.Tensor:
    """[B, S] fp32 waveform → [B, T, num_bins] log-mel (dither must be 0)."""
    _check_opts(opts)
    if wave.dim() != 2:
        raise ValueError(f"fused_fbank expects a [B, S] waveform, got {tuple(wave.shape)}")
    if wave.device.type == "cpu":
        return fused_fbank_plain(wave, opts)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_fbank: unsupported device {wave.device}")
    if wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError("fused_fbank: the kernel takes a contiguous float32 waveform")
    fo = opts.frame_opts
    b, s = wave.shape
    t_frames = W.num_frames(s, fo)
    nb = opts.mel_opts.num_bins
    out = torch.empty((b, t_frames, nb), dtype=torch.float32, device=wave.device)
    if b * t_frames == 0:
        return out
    win, cs, melw, band, _, wp, kp = _kernel_tables(opts, wave.device)
    lib = _lib()
    with torch.cuda.device(wave.device):
        rc = lib.pk2_fbank(D.ptr(wave), D.ptr(win), D.ptr(cs), D.ptr(melw), D.ptr(band),
                           D.ptr(out), b, s, t_frames, fo.window_size, wp,
                           fo.padded_window_size // 2, kp, nb, melw.numel(), fo.window_shift,
                           _first_sample(fo), int(fo.remove_dc_offset),
                           float(fo.preemph_coeff), float(W.FLT_EPSILON),
                           D.current_stream_ptr(wave.device))
    D.check_launch(rc, "fbank kernel (K1)")
    fused_fbank.launches += 1
    return out


fused_fbank.launches = 0


# ---------------------------------------------------------------------------
# K4: fused MFCC
# ---------------------------------------------------------------------------


def _check_mfcc_opts(opts: MfccOpts) -> None:
    if opts.frame_opts.dither != 0.0:
        raise ValueError("fused kernel expects dither pre-applied (or 0)")


def _mfcc_constants(opts: MfccOpts, n_samples: int, device: torch.device):
    """K1's constants for the MFCC's frame and mel options, plus the lifted
    DCT matrix transposed to [M, C]."""
    fb_like = FbankOpts(frame_opts=opts.frame_opts, mel_opts=opts.mel_opts)
    key = ("mfcc", _opts_key(fb_like), opts.num_ceps, opts.cepstral_lifter, n_samples,
           str(device))
    hit = _CONSTANTS.get(key)
    if hit is None:
        dct_t = torch.as_tensor(_lifted_dct_t(opts), dtype=torch.float32, device=device)
        hit = (*_constants(fb_like, n_samples, device), dct_t)
        _CONSTANTS[key] = hit
        while len(_CONSTANTS) > 16:
            _CONSTANTS.popitem(last=False)
    return hit


def fused_mfcc_plain(wave: torch.Tensor, opts: MfccOpts) -> torch.Tensor:
    """Plain torch version of K4: the same steps on the same constants."""
    _check_mfcc_opts(opts)
    idx, win, cos_w, sin_w, mel_t, dct_t = _mfcc_constants(opts, wave.shape[1], wave.device)
    frames = _centred_frames(wave, idx, opts.frame_opts)
    if opts.use_energy:  # raw energy: after DC removal, before pre-emphasis
        log_e = torch.log(torch.clamp((frames * frames).sum(-1), min=W.FLT_EPSILON))
        if opts.energy_floor > 0.0:
            log_e = torch.clamp(log_e, min=float(np.log(opts.energy_floor)))
    ceps = _logmel(frames, opts.frame_opts, win, cos_w, sin_w, mel_t) @ dct_t
    if opts.use_energy:
        ceps = torch.cat([log_e[..., None], ceps[..., 1:]], dim=-1)
    return ceps


def fused_mfcc(wave: torch.Tensor, opts: MfccOpts) -> torch.Tensor:
    """[B, S] fp32 waveform → [B, T, num_ceps] MFCC (dither must be 0)."""
    _check_mfcc_opts(opts)
    if wave.dim() != 2:
        raise ValueError(f"fused_mfcc expects a [B, S] waveform, got {tuple(wave.shape)}")
    if wave.device.type == "cpu":
        return fused_mfcc_plain(wave, opts)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_mfcc: unsupported device {wave.device}")
    if wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError("fused_mfcc: the kernel takes a contiguous float32 waveform")
    fo = opts.frame_opts
    b, s = wave.shape
    t_frames = W.num_frames(s, fo)
    nb, nc = opts.mel_opts.num_bins, opts.num_ceps
    out = torch.empty((b, t_frames, nc), dtype=torch.float32, device=wave.device)
    if b * t_frames == 0:
        return out
    win, cs, melw, band, dct_t, wp, kp = _kernel_tables(opts, wave.device)
    log_efloor = float(np.log(opts.energy_floor)) if opts.energy_floor > 0.0 else -np.inf
    lib = _lib()
    with torch.cuda.device(wave.device):
        rc = lib.pk2_mfcc(D.ptr(wave), D.ptr(win), D.ptr(cs), D.ptr(melw), D.ptr(band),
                          D.ptr(dct_t), D.ptr(out), b, s, t_frames, fo.window_size, wp,
                          fo.padded_window_size // 2, kp, nb, nc, melw.numel(),
                          fo.window_shift, _first_sample(fo), int(fo.remove_dc_offset),
                          float(fo.preemph_coeff), float(W.FLT_EPSILON), int(opts.use_energy),
                          log_efloor, D.current_stream_ptr(wave.device))
    D.check_launch(rc, "MFCC kernel (K4)")
    fused_mfcc.launches += 1
    return out


fused_mfcc.launches = 0


def kernel_tile(nrows: int, opts, mfcc: bool = False) -> tuple:
    """The tile K1 (or K4) takes for ``nrows`` rows under ``opts`` on the
    current card: (rows a thread, CTAs a row tile, row tiles a cluster
    sharing the table's stream, rows a tile)."""
    fo = opts.frame_opts
    wp, kp = kernel_table_shape(fo.window_size, fo.padded_window_size // 2)
    nnz = int(np.diff(mel_ranges(mel_banks(opts.mel_opts, fo)), axis=1).sum())
    out = [ctypes.c_int() for _ in range(4)]
    D.check_launch(_lib().pk2_fbank_tile(nrows, wp, kp, opts.mel_opts.num_bins, nnz, int(mfcc),
                                         *map(ctypes.byref, out)), "K1/K4 tile")
    return tuple(x.value for x in out)


def _declare(lib: ctypes.CDLL) -> None:
    """Give the library's entry points their C types."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pk2_fbank.argtypes = [vp] * 6 + [ci] * 12 + [cf, cf, vp]
    lib.pk2_fbank.restype = ci
    lib.pk2_mfcc.argtypes = [vp] * 7 + [ci] * 13 + [cf, cf, ci, cf, vp]
    lib.pk2_mfcc.restype = ci
    lib.pk2_fbank_tile.argtypes = [ci] * 6 + [ctypes.POINTER(ci)] * 4
    lib.pk2_fbank_tile.restype = ci
    lib._pk2_typed = True


def _lib() -> ctypes.CDLL:
    lib = D.load_kernel_lib("fbank")
    if not getattr(lib, "_pk2_typed", False):
        _declare(lib)
    return lib
