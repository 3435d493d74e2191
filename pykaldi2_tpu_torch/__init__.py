"""pykaldi2_tpu_torch — the PyTorch/CUDA port of pykaldi2_tpu for one NVIDIA H100.

The JAX package ``pykaldi2_tpu`` stays the reference; this package is a
second implementation beside it that imports ``torch`` and never ``jax`` or
anything of ``pykaldi2_tpu`` (numpy host modules are copied, not imported).

Every module of the JAX package has its port (ROADMAP.md, Queue 1), and
each Pallas kernel a hand-written CUDA C++ counterpart in ``csrc/``: the
fused fbank and MFCC (K1/K4), the LSTM and projected-LSTM recurrences
(K2/K3, K5/K6), the banded lattice forward-backward (K7-K10) and the
block-sparse matvec (K11). Entry points run on CUDA unless the caller asks
for the CPU (``device=`` or ``PK2_PLATFORM=cpu``).
"""

__version__ = "0.1.0"
