"""Acoustic models: LSTM/BLSTM stacks and the output head, as ``nn.Module``s.

Port of pykaldi2_tpu/models (reference behavior: pykaldi2/models/lstm.py
``LSTMStack`` and ``NnetAM``). TDNN and Transformer backbones and LSTMP come
with later slices.
"""

from pykaldi2_tpu_torch.models.lstm import LSTMStack
from pykaldi2_tpu_torch.models.nnet_am import NnetAM, build_model
