"""Plain fp32 reference of the on-the-fly MMI train step: the eval forward
that the search reads, the search (reference/lattice.py), then the MMI
objective over the lattice with frame dropping and CE smoothing, the
global-norm clip and SGD with momentum. Imports nothing of the program.

  obs      = acoustic_scale · (log softmax(logits) − log prior), the prior
             the relative frequency of each pdf in the alignments (floored
             at 1e-10);
  obj_b    = Σ_t sup · obs[t, ali_t] − den_scale · log Z_lattice(obs);
  loss     = −Σ_b obj_b / N + ce_ratio · CE / N, N the supervised frames;
  ∂/∂obs   = −(onehot(ali) − den_scale · γ) · sup · [γ(ali) > 1e-20] / N,
             γ the lattice's pdf occupancies (Kaldi's --drop-frames: a
             frame whose alignment pdf the lattice does not reach gives no
             gradient); the CE term's gradient is its own;
  update   = g ← g · min(1, clip / ‖g‖); v ← μ v + g; p ← p − lr · v.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import am, lattice

DROP_FLOOR = 1e-20


def log_prior(labels: list, num_pdfs: int) -> torch.Tensor:
    counts = np.zeros(num_pdfs, np.float64)
    for lab in labels:
        counts += np.bincount(lab[lab >= 0], minlength=num_pdfs)
    p = counts / max(counts.sum(), 1.0)
    return torch.from_numpy(np.log(np.maximum(p, 1e-10)).astype(np.float32))


def scores(params: dict, batch: dict, cfg: dict, prior: torch.Tensor, precision: str):
    """(logits, obs) of the batch's rows."""
    mask = batch["mask"].to(torch.float32)
    feats = am.fbank(batch["wave"], mask.shape[1], cfg["frontend"])
    if cfg["frontend"]["cmvn_norm_means"]:
        feats = am.mean_norm(feats, mask)
    logits = am.forward(params, feats, mask, cfg["model"], precision)
    obs = cfg["se"]["acoustic_scale"] * (torch.log_softmax(logits, dim=-1) - prior)
    return logits, obs


class Momentum:
    def __init__(self, params: dict, lr: float, momentum: float, clip: float):
        self.lr, self.mu, self.clip = lr, momentum, clip
        self.v = None

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = {k: g * scale for k, g in grads.items()}
        if self.v is None:
            self.v = {k: g.clone() for k, g in grads.items()}
        else:
            for k, g in grads.items():
                self.v[k].mul_(self.mu).add_(g)
        for k in params:
            params[k].sub_(self.lr * self.v[k])
        return grads


def mmi_step(params: dict, batch: dict, lat: dict, cfg: dict, prior: torch.Tensor,
             precision: str, keep_rows: float = 1.0):
    """(loss, {leaf: gradient}, the scores of all the batch's rows) of one
    step over the lattice ``lat``."""
    se = cfg["se"]
    rows = max(1, int(round(batch["wave"].shape[0] * keep_rows)))
    obs_all = None
    if rows < batch["wave"].shape[0]:
        with torch.no_grad():
            obs_all = scores(params, batch, cfg, prior, precision)[1]
    batch = {k: v[:rows] for k, v in batch.items()}
    lat = {k: v[:rows] for k, v in lat.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits, obs = scores(leaves, batch, cfg, prior, precision)
    labels = batch["labels"].long()
    nf = batch["num_frames"]
    sup = batch["mask"].to(torch.float32) * (labels >= 0)
    count = torch.clamp(sup.sum(), min=1.0)
    ali = torch.clamp(labels, min=0)[..., None]
    obs_d = obs.detach().requires_grad_(True)
    log_z = lattice.logz(obs_d, lat, nf)
    gamma, = torch.autograd.grad(log_z.sum(), obs_d)
    with torch.no_grad():
        num = (torch.gather(obs_d, 2, ali)[..., 0] * sup).sum(dim=1)
        obj = torch.where(nf.to(obs.device) > 0, num - se["den_scale"] * log_z,
                          torch.zeros_like(num)).sum()
        keep = sup
        if se["drop_frames"]:
            keep = keep * (torch.gather(gamma, 2, ali)[..., 0] > DROP_FLOOR)
        d_obs = (-se["den_scale"] * gamma).scatter_add_(2, ali, torch.ones_like(gamma[..., :1]))
        d_obs = d_obs * keep[..., None]
    nll = -(torch.gather(torch.log_softmax(logits, dim=-1), 2, ali)[..., 0] * sup).sum()
    surrogate = -(obs * d_obs).sum() / count + se["ce_ratio"] * nll / count
    grads = torch.autograd.grad(surrogate, list(leaves.values()))
    loss = float(-obj / count + se["ce_ratio"] * nll.detach() / count)
    return loss, dict(zip(leaves, grads)), obs.detach() if obs_all is None else obs_all


def train_steps(params: dict, steps: list, cfg: dict, prior: torch.Tensor, precision: str,
                keep_rows: float = 1.0) -> dict:
    """The steps ``[(batch, lattice), ...]`` from ``params`` (changed in
    place) → {"loss", "grad", "change"} as in reference/am.py."""
    am.set_fp32_exact()
    opt = cfg["optimizer"]
    p0 = {k: v.detach().clone() for k, v in params.items()}
    sgd = Momentum(params, opt["lr"], opt["momentum"], opt["grad_clip"])
    out = {"loss": [], "grad": {}, "change": {}}
    for i, (batch, lat) in enumerate(steps):
        loss, grads, _obs = mmi_step(params, batch, lat, cfg, prior, precision, keep_rows)
        clipped = sgd.step(params, grads)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = {k: float(g.norm()) for k, g in clipped.items()}
        del grads, clipped
    out["change"] = {k: float((params[k] - p0[k]).norm()) for k in params}
    return out
