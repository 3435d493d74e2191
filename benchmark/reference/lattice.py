"""Plain reference of the batched beam search that generates denominator
lattices, and of the lattice forward over its banded output, in fp32 torch.
Imports nothing of the program.

Search, one frame t (scores are log probabilities; −1e30 is "none"):

  new[s]   = max over in-arcs (a[src] + w) + obs_t[pdf(s)]
  frontier = the K best states of ``new`` (ties to the lowest state id),
             kept within ``beam`` of the best; the next frame's scores are
             ``new`` where at least the frontier's cutoff (the K-th kept
             score, or best − beam);
  slots    = frontier positions within ``lattice_beam`` of the best;
  links    = for each slot, its in-arcs from states that held a slot the
             frame before, whose score (a[src] + w + obs) is within
             ``lattice_beam`` of the slot's own; the A best are kept.

After an utterance's last frame its scores and slots are frozen. The
lattice's finals are the last frame's slots' final weights, or 0 on every
slot when none of them is final. A link carries (source slot, slot, pdf,
graph weight); the forward adds obs[t, pdf]. Slot 0 before frame 0 is the
start state.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30
HALF = -5e29


def in_tables(graph: dict, device) -> dict:
    """Per-destination in-arc tables [S, D] (source, weight; padded with
    source 0 and weight −1e30) and each state's pdf, from the arc list."""
    s = graph["num_states"]
    dst = graph["dst"]
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=s)
    d = int(counts.max())
    rank = np.arange(len(dst)) - (np.cumsum(counts) - counts)[dst[order]]
    src_t = np.zeros((s, d), np.int64)
    w_t = np.full((s, d), NEG, np.float32)
    src_t[dst[order], rank] = graph["src"][order]
    w_t[dst[order], rank] = graph["w"][order]
    pdf = np.zeros(s, np.int64)
    pdf[dst] = graph["pdf"]
    final = np.where(np.isfinite(graph["final"]), graph["final"], NEG).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {"src": t(src_t), "w": t(w_t), "pdf": t(pdf), "final": t(final),
            "start": graph["start"], "S": s, "D": d}


def _top_k(new: torch.Tensor, k: int):
    """The k highest scores and their states, ties to the lowest state."""
    order = torch.sort(-new, dim=1, stable=True).indices[:, :k]
    return new.gather(1, order), order


@torch.no_grad()
def search(obs: torch.Tensor, num_frames: torch.Tensor, tab: dict, max_active: int,
           max_arcs: int, beam: float, lattice_beam: float) -> dict:
    """obs [B, T, P] fp32 → {"src", "dst", "pdf", "weight"} [B, T, A'] and
    "final" [B, K]; A' ≤ ``max_arcs`` covers the largest frame."""
    b, t_len, _p = obs.shape
    dev = obs.device
    S, D = tab["S"], tab["D"]
    K = min(max_active, S)
    slot_ids = torch.arange(K, device=dev).expand(b, K)
    alpha = torch.full((b, S), NEG, device=dev)
    alpha[:, tab["start"]] = 0.0
    slot_prev = torch.full((b, S), -1, dtype=torch.int64, device=dev)
    slot_prev[:, tab["start"]] = 0
    nf = num_frames.to(dev).long()
    frames, last_vals, last_idx = [], None, None
    for t in range(t_len):
        obs_s = obs[:, t].index_select(1, tab["pdf"])
        relax = torch.clamp_min(alpha[:, tab["src"]] + tab["w"], NEG)        # [B, S, D]
        m = relax.amax(dim=2)
        new = torch.where(m > HALF, m + obs_s, torch.full_like(m, NEG))
        best = new.amax(dim=1, keepdim=True)
        vals, idx = _top_k(new, K)
        keep = (vals >= best - beam) & (vals > HALF)
        emit = keep & (vals >= best - lattice_beam)
        cutoff = torch.maximum(best - beam,
                               torch.where(keep[:, K - 1:], vals[:, K - 1:], best - beam))
        alpha_next = torch.where(new >= cutoff, new, torch.full_like(new, NEG))
        slot_cur = torch.full_like(slot_prev, -1).scatter_reduce(
            1, idx, torch.where(emit, slot_ids, -1), "amax")
        a_emit = torch.where(slot_prev >= 0, alpha, torch.full_like(alpha, NEG))
        src_kd = tab["src"][idx]                                             # [B, K, D]
        w_kd = tab["w"][idx]
        link = torch.clamp_min(a_emit.gather(1, src_kd.view(b, K * D)).view(b, K, D) + w_kd,
                               NEG) + obs_s.gather(1, idx)[:, :, None]
        active = (t < nf)[:, None, None]
        ok = ((link >= vals[:, :, None] - lattice_beam) & (link > HALF) & emit[:, :, None]
              & active)
        score = torch.where(ok, link, torch.full_like(link, NEG)).view(b, K * D)
        top = torch.sort(-score, dim=1, stable=True).indices[:, :max_arcs]
        valid = score.gather(1, top) > HALF
        kpos = top // D
        frames.append({
            "src": torch.where(valid, slot_prev.gather(1, src_kd.view(b, K * D).gather(1, top)),
                               0),
            "dst": torch.where(valid, kpos, 0),
            "pdf": torch.where(valid, tab["pdf"][idx.gather(1, kpos)], 0),
            "weight": torch.where(valid, w_kd.view(b, K * D).gather(1, top),
                                  torch.full_like(top, NEG, dtype=torch.float32)),
            "n": valid.sum(dim=1)})
        act = (t < nf)[:, None]
        if last_vals is None:
            last_vals, last_idx = vals.clone(), idx.clone()
        last_vals = torch.where(act, vals, last_vals)
        last_idx = torch.where(act, idx, last_idx)
        alpha = torch.where(act, alpha_next, alpha)
        slot_prev = torch.where(act, slot_cur, slot_prev)
    a_keep = max(1, int(max(int(f["n"].max()) for f in frames)))
    out = {k: torch.stack([f[k][:, :a_keep] for f in frames], dim=1)
           for k in ("src", "dst", "pdf", "weight")}
    best_t = last_vals.amax(dim=1, keepdim=True)
    keep_t = (last_vals >= best_t - beam) & (last_vals > HALF)
    emit_t = keep_t & (last_vals >= best_t - lattice_beam)
    fin = torch.where(keep_t, tab["final"][last_idx], torch.full_like(last_vals, NEG))
    emit_fin = torch.where(emit_t, fin, torch.full_like(fin, NEG))
    has = (emit_fin.amax(dim=1, keepdim=True) > HALF)
    out["final"] = torch.where(has, emit_fin, torch.where(emit_t, torch.zeros_like(fin),
                                                          torch.full_like(fin, NEG)))
    return out


def logz(obs: torch.Tensor, lat: dict, num_frames: torch.Tensor) -> torch.Tensor:
    """log Z [B] of each utterance's lattice under ``obs`` [B, T, P]
    (differentiable in ``obs``): the forward over links, each frame's
    scores renormalised by their max, frozen after the last frame. The
    shifts are constants to the gradient (log Z does not depend on them), so
    a link on no complete path gets an occupancy of exactly 0."""
    b, t_len, _p = obs.shape
    k = lat["final"].shape[1]
    dev = obs.device
    src, dst, pdf = lat["src"].long(), lat["dst"].long(), lat["pdf"].long()
    w = lat["weight"].float()
    alpha = torch.full((b, k), NEG, device=dev)
    alpha[:, 0] = 0.0
    norm = torch.zeros(b, device=dev)
    nf = num_frames.to(dev).long()
    obs_arc = torch.gather(obs, 2, pdf)                                      # [B, T, A]
    for t in range(t_len):
        score = alpha.gather(1, src[:, t]) + w[:, t] + obs_arc[:, t]
        score = torch.where(w[:, t] > HALF, score, torch.full_like(score, NEG))
        mx = torch.clamp_min(score.amax(dim=1, keepdim=True), NEG).detach()
        summed = torch.zeros(b, k, device=dev).scatter_add(1, dst[:, t], torch.exp(score - mx))
        pos = summed > 0
        new = torch.where(pos, torch.log(torch.where(pos, summed, torch.ones_like(summed)))
                          + mx, torch.full_like(summed, NEG))
        shift = new.amax(dim=1).detach()
        act = t < nf
        alpha = torch.where(act[:, None], new - shift[:, None], alpha)
        norm = torch.where(act, norm + shift, norm)
    return torch.logsumexp(torch.clamp_min(alpha + lat["final"], NEG), dim=1) + norm
