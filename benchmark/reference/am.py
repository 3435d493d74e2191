"""Plain fp32 reference of the CE train step of an LSTM or (B)LSTMP acoustic
model: Kaldi fbank, per-utterance mean normalisation, the recurrent stack,
the output layer, the masked cross-entropy, then the global-norm clip and
Adam. Written from Kaldi's definitions and the equations the program's
docstrings state, in plain torch; nothing of the program is imported.

Equations (gate order i, f, g, o):

  fbank:  frames of 400 samples every 160 (snip edges), DC offset removed,
          pre-emphasis 0.97 (w[0] -= 0.97 w[0]), Povey window
          (hann ** 0.85), zero-padded to 512, power spectrum without the
          Nyquist bin, triangular mel banks on 1127 ln(1 + f / 700) between
          low_freq and Nyquist, log floored at FLT_EPSILON (Kaldi
          feature-fbank.cc, mel-computations.cc, feature-window.cc);
  cmvn:   each row minus its mean over its valid frames;
  lstm:   z = x W_x + b + r_{t-1} W_h; c = σ(z_f) c + σ(z_i) tanh(z_g);
          h = σ(z_o) tanh(c); r_t = h, or r_t = h W_p with a projection;
          on a masked frame r and c keep their previous values, and the
          reversed direction runs the same cell over the time-flipped rows;
          a bidirectional layer concatenates [forward, reversed];
  output: logits = y W_out + b_out; loss = Σ −log softmax(logits)[label]
          over the supervised frames, over their count;
  update: g ← g · min(1, clip / ‖g‖) when ‖g‖ ≥ clip (the norm over all
          leaves), then Adam (β = 0.9, 0.999, ε = 1e-8, bias-corrected).

Departures: none in the arithmetic. Every product is fp32 (TF32 off); the
program multiplies bf16 operands with fp32 sums, which is the gap the
comparison allows. ``precision="fp8"`` rounds every product's operands to
float8 e4m3 with a per-tensor scale, in the forward and both backward
products: the control, one precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FLT_EPSILON = float(np.finfo(np.float32).eps)
FP8_MAX = 448.0


def set_fp32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# products
# --------------------------------------------------------------------------


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _MatmulFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _fp8(a) @ _fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _fp8(g) @ _fp8(b).t(), _fp8(a).t() @ _fp8(g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [..., K] @ b [K, M] in fp32, or with fp8-rounded operands."""
    if precision == "fp32":
        return a @ b
    if precision == "fp8":
        lead = a.shape[:-1]
        return _MatmulFp8.apply(a.reshape(-1, a.shape[-1]), b).reshape(*lead, b.shape[1])
    raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------------------
# front end
# --------------------------------------------------------------------------


def mel_scale(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_banks(num_bins: int, low_freq: float, high_freq: float, samp_freq: float,
              n_fft: int) -> np.ndarray:
    """Kaldi MelBanks: [num_bins, n_fft // 2] triangular weights."""
    nyquist = 0.5 * samp_freq
    high = high_freq if high_freq > 0 else nyquist + high_freq
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high)
    delta = (mel_high - mel_low) / (num_bins + 1)
    out = np.zeros((num_bins, n_fft // 2), np.float64)
    for b in range(num_bins):
        left, center, right = (mel_low + k * delta for k in (b, b + 1, b + 2))
        for i in range(n_fft // 2):
            mel = float(mel_scale(i * samp_freq / n_fft))
            if left < mel < right:
                out[b, i] = ((mel - left) / (center - left) if mel <= center
                             else (right - mel) / (right - center))
    return out.astype(np.float32)


def povey_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * math.pi * i / (n - 1))) ** 0.85).astype(np.float32)


def fbank(wave: torch.Tensor, num_frames: int, fe: dict) -> torch.Tensor:
    """wave [B, S] (int16-range fp32) → log-mel [B, num_frames, bins] fp32."""
    shift = int(fe["samp_freq"] * fe["frame_shift_ms"] / 1000)
    length = int(fe["samp_freq"] * fe["frame_length_ms"] / 1000)
    n_fft = 1 << (length - 1).bit_length()
    idx = (torch.arange(num_frames, device=wave.device)[:, None] * shift
           + torch.arange(length, device=wave.device)[None, :])
    x = wave[:, idx].to(torch.float32)                               # [B, T, L]
    x = x - x.mean(dim=-1, keepdim=True)
    c = fe["preemph_coeff"]
    x = torch.cat([x[..., :1] * (1.0 - c), x[..., 1:] - c * x[..., :-1]], dim=-1)
    x = x * torch.as_tensor(povey_window(length), device=wave.device)
    spec = torch.fft.rfft(x, n=n_fft, dim=-1)[..., : n_fft // 2]
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = torch.as_tensor(mel_banks(fe["num_mel_bins"], fe["low_freq"], fe["high_freq"],
                                    fe["samp_freq"], n_fft), device=wave.device)
    return torch.log(torch.clamp(power @ mel.t(), min=FLT_EPSILON))


def mean_norm(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None]
    mean = (feats * m).sum(dim=1, keepdim=True) / torch.clamp(m.sum(dim=1, keepdim=True),
                                                              min=1.0)
    return feats - mean


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def lstm_direction(x: torch.Tensor, mask: torch.Tensor, p: dict, precision: str,
                   reverse: bool) -> torch.Tensor:
    """x [B, T, D], mask [B, T] → [B, T, H or P]."""
    if reverse:
        x, mask = x.flip(1), mask.flip(1)
    b, t_len, _ = x.shape
    h4 = p["wx"].shape[1]
    hid = h4 // 4
    z_in = matmul(x, p["wx"], precision) + p["b"]
    r = x.new_zeros(b, p["wh"].shape[0])
    c = x.new_zeros(b, hid)
    ys = []
    for t in range(t_len):
        z = z_in[:, t] + matmul(r, p["wh"], precision)
        i, f = torch.sigmoid(z[:, :hid]), torch.sigmoid(z[:, hid:2 * hid])
        g, o = torch.tanh(z[:, 2 * hid:3 * hid]), torch.sigmoid(z[:, 3 * hid:])
        c_new = f * c + i * g
        h = o * torch.tanh(c_new)
        r_new = matmul(h, p["wp"], precision) if "wp" in p else h
        valid = mask[:, t, None] > 0
        r = torch.where(valid, r_new, r)
        c = torch.where(valid, c_new, c)
        ys.append(r)
    y = torch.stack(ys, dim=1)
    return y.flip(1) if reverse else y


def forward(params: dict, feats: torch.Tensor, mask: torch.Tensor, model: dict,
            precision: str) -> torch.Tensor:
    """Logits [B, T, output_size]."""
    h = feats
    dirs = ("fwd", "bwd") if model["bidirectional"] else ("fwd",)
    for layer in range(model["num_layers"]):
        outs = []
        for d in dirs:
            pre = f"nnet.layers.{layer}.{d}."
            p = {k: params[pre + k] for k in ("wx", "wh", "b", "wp") if pre + k in params}
            outs.append(lstm_direction(h, mask, p, precision, reverse=d == "bwd"))
        h = torch.cat(outs, dim=-1)
    return matmul(h, params["out_w"], precision) + params["out_b"]


def ce_nll_sum(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ −log softmax(logits)[label] over the supervised frames."""
    sup = mask * (labels >= 0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    return -(ll * sup).sum()


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


class Adam:
    def __init__(self, params: dict, lr: float, clip: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Clips ``grads`` over all leaves, updates ``params`` in place;
        returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat, v_hat = self.m[k] / bc1, self.v[k] / bc2
            params[k].sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        return grads


def train_steps(params: dict, batches: list, cfg: dict, opt: dict, precision: str,
                keep_rows: float = 1.0, block_rows: int = 256) -> dict:
    """The CE steps over ``batches`` (each {wave, labels, mask} on one
    device) from ``params`` (changed in place), the loss and its gradient
    summed over blocks of ``block_rows`` rows so that they fit. Returns
    {"loss": [per step], "grad": {leaf: ‖clipped first gradient‖},
    "change": {leaf: ‖p − p0‖}} as floats. ``keep_rows`` < 1 trains on that
    leading share of each batch's rows only (a fault the check must catch)."""
    set_fp32_exact()
    model, fe = cfg["model"], cfg["frontend"]
    p0 = {k: v.detach().clone() for k, v in params.items()}
    adam = Adam(params, opt["lr"], opt["grad_clip"])
    out = {"loss": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches):
        rows = max(1, int(round(batch["wave"].shape[0] * keep_rows)))
        labels_all = batch["labels"][:rows]
        mask_all = batch["mask"][:rows].to(torch.float32)
        count = torch.clamp((mask_all * (labels_all >= 0)).sum(), min=1.0)
        total = torch.zeros((), device=mask_all.device)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        for r0 in range(0, rows, block_rows):
            r1 = min(rows, r0 + block_rows)
            mask, labels = mask_all[r0:r1], labels_all[r0:r1]
            feats = fbank(batch["wave"][r0:r1], mask.shape[1], fe)
            if fe["cmvn_norm_means"]:
                feats = mean_norm(feats, mask)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            nll = ce_nll_sum(forward(leaves, feats, mask, model, precision), labels, mask)
            loss = nll / count
            for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
                grads[k] += g
            total += loss.detach()
            del leaves, nll, loss, feats
        clipped = adam.step(params, grads)
        out["loss"].append(float(total))
        if step == 0:
            out["grad"] = {k: float(g.norm()) for k, g in clipped.items()}
        del grads, clipped
    out["change"] = {k: float((params[k] - p0[k]).norm()) for k in params}
    return out
