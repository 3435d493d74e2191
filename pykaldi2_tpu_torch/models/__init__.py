"""Acoustic models: LSTM/BLSTM/LSTMP, TDNN and Transformer stacks and the
output head, as ``nn.Module``s.

Port of pykaldi2_tpu/models (reference behavior: pykaldi2/models/lstm.py
``LSTMStack`` and ``NnetAM``).
"""

from pykaldi2_tpu_torch.models.lstm import LSTMStack
from pykaldi2_tpu_torch.models.nnet_am import NnetAM, build_model
from pykaldi2_tpu_torch.models.tdnn import TDNNStack
from pykaldi2_tpu_torch.models.transformer import TransformerStack
