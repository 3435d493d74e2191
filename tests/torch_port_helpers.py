"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the reference: the same numpy inputs go through a JAX
function and its port, and the outputs are compared as numpy arrays. Where
the JAX path reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it on the CPU (tests/test_lstm_pallas.py:12-23).
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run pallas kernels in interpreter mode on CPU and route the JAX
    package's LSTM and fbank through them (PK2_PALLAS_LSTM/FBANK=1)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True  # fused_fbank passes interpret=False explicitly
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setenv("PK2_PALLAS_LSTM", "1")
    monkeypatch.setenv("PK2_PALLAS_FBANK", "1")


def to_np(x) -> np.ndarray:
    """jax array / torch tensor → float numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def torch_batch(batch: dict) -> dict:
    """numpy batch dict → torch tensors (host-side entries pass through)."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def state_graph_arrays(seed=0, num_states=23, num_pdfs=5, num_arcs=70, all_final=True) -> dict:
    """Random graph honoring the state-emission invariant (arcs into a state
    carry its pdf), as tests/test_fb_block.py:36-51 and test_fb_dense.py:27-40
    build them; a DenseFsa's fields as numpy arrays. ``all_final``: every
    state final with a random weight, else one final state and the start."""
    rng = np.random.RandomState(seed)
    state_pdf = rng.randint(0, num_pdfs, num_states)
    src = rng.randint(0, num_states, num_arcs).astype(np.int32)
    src[0] = 0
    dst = rng.randint(0, num_states, num_arcs).astype(np.int32)
    weight = (rng.randn(num_arcs) * 0.5).astype(np.float32)
    if all_final:
        final = (rng.randn(num_states) * 0.5).astype(np.float32)
    else:
        final = np.full(num_states, -np.inf, np.float32)
        final[rng.randint(1, num_states)] = 0.0
        final[0] = -0.5
    return dict(num_states=num_states, src=src, dst=dst, pdf=state_pdf[dst].astype(np.int32),
                weight=weight, final=final, start=0,
                phone=(state_pdf[dst] + 1).astype(np.int32))


def chain_fsa_arrays(num_chains=6, chain_len=20, num_pdfs=5) -> dict:
    """Chain-structured graph of tests/test_fb_block.py:335-354 (start fans
    out to chains, each state self-loops and advances), with phone labels."""
    rng = np.random.RandomState(3)
    S = 1 + num_chains * chain_len
    state_pdf = rng.randint(0, num_pdfs, S)
    src, dst, wt = [], [], []
    for c in range(num_chains):
        base = 1 + c * chain_len
        src.append(0)
        dst.append(base)
        wt.append(rng.randn() * 0.3)
        for i in range(chain_len):
            s = base + i
            src.append(s)
            dst.append(s)
            wt.append(-0.7)
            if i + 1 < chain_len:
                src.append(s)
                dst.append(s + 1)
                wt.append(-0.7)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    final = np.full(S, -np.inf, np.float32)
    final[np.arange(num_chains) * chain_len + chain_len] = 0.0
    return dict(num_states=S, src=src, dst=dst, pdf=state_pdf[dst].astype(np.int32),
                weight=np.asarray(wt, np.float32), final=final, start=0,
                phone=(state_pdf[dst] + 1).astype(np.int32))


def both_fsas(arrays: dict):
    """The same graph as a JAX-package DenseFsa and a port DenseFsa."""
    from pykaldi2_tpu.ops.fsa import DenseFsa as JaxFsa
    from pykaldi2_tpu_torch.ops.fsa import DenseFsa

    return JaxFsa(**arrays).validate(), DenseFsa(**arrays).validate()


def value_and_grad_both(jax_fn, torch_fn, obs: np.ndarray):
    """(value, d sum(value)/d obs) of a JAX function and its port on the
    same obs, as numpy."""
    import jax
    import jax.numpy as jnp
    import torch

    jv, jg = jax.value_and_grad(lambda o: jnp.sum(jax_fn(o)))(jnp.asarray(obs))
    o = torch.tensor(obs, requires_grad=True)
    tv = torch_fn(o)
    tv.sum().backward()
    return (to_np(tv), to_np(o.grad)), (np.asarray(jax_fn(jnp.asarray(obs))), np.asarray(jg))


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side of a test module whose
    recursions run many tiny ops: the suite runs several workers on a few
    cores, and a thread pool per worker spends more time synchronising than
    computing. The previous setting is restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
