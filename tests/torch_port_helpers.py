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
