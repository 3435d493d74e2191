"""Data layer: readers, datasets, the chunk batcher, device prefetch.

Numpy copies of pykaldi2_tpu/data (reference behavior: pykaldi2/data/ and
pykaldi2/reader/): the host produces fixed-shape numpy batches, and
``device_prefetch`` pins and copies them to the device ahead of the step.
"""

from pykaldi2_tpu_torch.data.wav import read_wav, write_wav
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.dataset import SpeechDataset, Utterance
from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader, SeqDataloader, BucketSpec
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
