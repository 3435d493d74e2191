"""pykaldi2_tpu_torch — the PyTorch/CUDA port of pykaldi2_tpu for one NVIDIA H100.

The JAX package ``pykaldi2_tpu`` stays the reference; this package is a
second implementation beside it that imports ``torch`` and never ``jax`` or
anything of ``pykaldi2_tpu`` (numpy host modules are copied, not imported).

Ported so far: frame-level CE training of the LSTM acoustic model from raw
audio — front end (framing, windowing, fbank, CMVN, deltas, splicing), the
fused fbank kernel (K1, ``csrc/fbank.cu``), the LSTM recurrence kernels
(K2/K3, ``csrc/lstm.cu``), the (B)LSTM stack and output head, CE loss, the
optimizers, npz checkpoints that load in either package, the chunk data
loader and the ``bin/train_ce.py`` CLI. Entry points run on CUDA unless the
caller asks for the CPU (``device=`` or ``PK2_PLATFORM=cpu``).
"""

__version__ = "0.1.0"
