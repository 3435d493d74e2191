"""Kaldi-parity feature front end in torch, with the fused fbank (K1) and
fused MFCC (K4) kernels.

Port of pykaldi2_tpu/frontend (reference behavior: kaldi/src/feat/). All
framing/windowing/DFT/mel work is batched fp32 torch ops; the mel matrix and
window vectors are host-built numpy constants.
"""

from pykaldi2_tpu_torch.frontend.window import (
    num_frames,
    extract_frames,
    process_frames,
    feature_window,
)
from pykaldi2_tpu_torch.frontend.mel import mel_banks, mel_scale, inverse_mel_scale
from pykaldi2_tpu_torch.frontend.fbank import compute_fbank, fbank_dim
from pykaldi2_tpu_torch.frontend.mfcc import compute_mfcc
from pykaldi2_tpu_torch.frontend.cmvn import (
    acc_cmvn_stats,
    apply_cmvn,
    apply_cmvn_sliding,
    utterance_cmvn,
)
from pykaldi2_tpu_torch.frontend.delta import add_deltas, delta_matrix
from pykaldi2_tpu_torch.frontend.splice import splice_frames
