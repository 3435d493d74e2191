"""Dataclass configs mirroring the reference's two-YAML convention.

The reference (pykaldi2/bin/train_ce.py, train_se.py) takes ``-config``
(model/optimizer/trainer hyperparameters) and ``-data`` (corpus + simulation
spec) YAML files plus argparse overrides.  We keep the same split and the same
top-level key shapes so reference recipes port over, but load into typed
dataclasses.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------


@dataclass
class FrameOpts:
    """Kaldi FrameExtractionOptions (reference: kaldi/src/feat/feature-window.h)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 0.0          # reference default 1.0; 0 for deterministic tests
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"   # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


@dataclass
class MelOpts:
    """Kaldi MelBanksOptions (reference: kaldi/src/feat/mel-computations.h)."""

    num_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 → nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    vtln_warp: float = 1.0


@dataclass
class FbankOpts:
    """Kaldi FbankOptions (reference: kaldi/src/feat/feature-fbank.h)."""

    frame_opts: FrameOpts = field(default_factory=FrameOpts)
    mel_opts: MelOpts = field(default_factory=MelOpts)
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True


@dataclass
class MfccOpts:
    """Kaldi MfccOptions (reference: kaldi/src/feat/feature-mfcc.h)."""

    frame_opts: FrameOpts = field(default_factory=FrameOpts)
    mel_opts: MelOpts = field(default_factory=lambda: MelOpts(num_bins=23))
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


@dataclass
class CmvnOpts:
    norm_means: bool = True
    norm_vars: bool = False
    stats_path: Optional[str] = None  # global stats; None → per-utterance
    # per-speaker CMVN (Kaldi apply-cmvn --utt2spk= scp:cmvn.scp semantics):
    utt2spk: Optional[str] = None       # 'utt spk' table
    spk_stats_scp: Optional[str] = None  # spk → [2,D+1] stats matrix scp


@dataclass
class FeatConfig:
    type: str = "fbank"  # fbank|mfcc
    fbank: FbankOpts = field(default_factory=FbankOpts)
    mfcc: MfccOpts = field(default_factory=MfccOpts)
    cmvn: CmvnOpts = field(default_factory=CmvnOpts)
    delta_order: int = 0      # 0 = no deltas; 2 = delta+delta-delta
    delta_window: int = 2
    splice_left: int = 0      # frame splicing context for TDNN-style inputs
    splice_right: int = 0
    # per-utterance VTLN warps (Kaldi --vtln-map): 'utt warp_factor' table;
    # distinct warps become a quantized mel-matrix bank selected per row
    utt2warp: Optional[str] = None


# ---------------------------------------------------------------------------
# Simulation (reference: pykaldi2/simulation/)
# ---------------------------------------------------------------------------


@dataclass
class ReverbConfig:
    use_reverb: bool = False
    prob: float = 0.5
    rir_list: Optional[str] = None      # file of RIR wav paths; None → synthesize
    rt60_range: tuple = (0.1, 0.6)      # synthesized RIR T60 range (s)
    room_dim_range: tuple = (3.0, 10.0)


@dataclass
class NoiseConfig:
    use_noise: bool = False
    prob: float = 0.5
    noise_list: Optional[str] = None    # file of noise wav paths; None → synthesize
    snr_range: tuple = (0.0, 20.0)      # dB


@dataclass
class PerturbConfig:
    use_gain: bool = False
    gain_range: tuple = (-10.0, 5.0)    # dB, a.k.a. volume perturbation
    use_speed: bool = False
    speed_choices: tuple = (0.9, 1.0, 1.1)


@dataclass
class SimulationConfig:
    enabled: bool = False
    # on_device: reverb/noise/gain run inside the jitted train step (host
    # samples RIR/noise tensors per batch, the TPU applies them — the
    # "HBM-resident simulated batches" path); speed perturbation always
    # stays host-side because it changes sequence length
    on_device: bool = False
    reverb: ReverbConfig = field(default_factory=ReverbConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    perturb: PerturbConfig = field(default_factory=PerturbConfig)
    seed: int = 0


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@dataclass
class DataConfig:
    """The '-data' YAML: corpus locations + simulation."""

    wav_scp: Optional[str] = None        # utt_id → wav path (or wav.zip member)
    feats_scp: Optional[str] = None      # precomputed feature matrices (Kaldi scp)
    hdf5: Optional[str] = None           # hdf5 corpus archive (data/hdf5_io.py layout)
    hdf5_kind: str = "wave"              # wave|feats datasets inside the archive
    label_ark: Optional[str] = None      # alignment ark/scp (pdf-ids or transition-ids)
    ali_are_pdf_ids: bool = True         # False → map tid→pdf via TransitionModel
    trans_model: Optional[str] = None
    feat: FeatConfig = field(default_factory=FeatConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    num_workers: int = 0
    shuffle: bool = True


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    type: str = "lstm"            # lstm|blstm|tdnn|transformer
    input_size: int = 80
    hidden_size: int = 1024
    num_layers: int = 4
    output_size: int = 9000       # senone / pdf-id count
    dropout: float = 0.0
    bidirectional: bool = False
    proj_size: int = 0            # LSTMP projection; 0 = off
    # TDNN specifics
    tdnn_dilations: tuple = (1, 1, 3, 3, 3)
    tdnn_kernel: int = 3
    # Transformer specifics
    num_heads: int = 8
    ffn_size: int = 2048
    # numerics
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclass
class OptimizerConfig:
    type: str = "sgd"             # sgd|adam|momentum
    lr: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    # LR schedule (reference anneals LR per-epoch on dev-loss plateau)
    anneal_factor: float = 0.5
    anneal_patience: int = 1
    warmup_steps: int = 0
    # gradient allreduce compression (Horovod's optional fp16 compression,
    # SURVEY §3.3/§6.8): "none" | "bf16" — halves cross-device gradient
    # traffic; mainly useful over DCN on multihost meshes
    grad_compression: str = "none"


@dataclass
class TrainerConfig:
    batch_size: int = 64
    chunk_len: int = 80           # CE chunk length in frames (ChunkDataloader)
    chunk_overlap: int = 0        # context frames shared with the previous
                                  # chunk (model-visible, loss-masked)
    num_epochs: int = 8
    sweep_size: float = 1.0       # fraction of data per epoch (reference -sweep_size)
    log_interval: int = 100
    seed: int = 777
    exp_dir: str = "exp"
    resume_from_model: Optional[str] = None
    seed_model: Optional[str] = None
    # sequence training (train_se)
    criterion: str = "mmi"        # mmi|smbr|mpfe (a.k.a. mpe)
    den_graph: Optional[str] = None
    prior_path: Optional[str] = None
    acoustic_scale: float = 0.1
    den_scale: float = 1.0
    drop_frames: bool = True
    ce_ratio: float = 0.1         # CE smoothing weight for SE (f-smoothing)
    # Kaldi MpeVariants silence handling (sMBR/MPE accuracy): silence frames
    # never score correct; with one_silence_class all silence phones count
    # as one class (silence-vs-silence is correct)
    silence_phones: tuple = ()
    one_silence_class: bool = False
    # sequence-mode bucket inventory (SeqDataloader): max frame counts
    bucket_boundaries: tuple = (200, 400, 800, 1600)
    # lattice decode opts for on-the-fly denominator mode
    beam: float = 16.0
    lattice_beam: float = 8.0
    max_active: int = 7000
    # device mesh
    mesh_shape: Optional[dict] = None   # e.g. {"data": 8} or {"data": 4, "model": 2}


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    data: DataConfig = field(default_factory=DataConfig)


# ---------------------------------------------------------------------------
# YAML loading with dotted-path overrides
# ---------------------------------------------------------------------------


def _build(cls, raw: Any):
    """Recursively build a dataclass from a nested dict, tolerating extras."""
    if raw is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return raw
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        v = raw[f.name]
        ftype = hints.get(f.name, f.type)
        origin = typing.get_origin(ftype)
        if dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _build(ftype, v)
        elif ftype is tuple or origin is tuple:
            kwargs[f.name] = tuple(v)
        elif origin is typing.Union:  # Optional[...]
            kwargs[f.name] = v
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    raw = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    cfg = _build(Config, raw)
    for dotted, value in (overrides or {}).items():
        _set_dotted(cfg, dotted, value)
    return cfg


def load_data_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> DataConfig:
    raw = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    cfg = _build(DataConfig, raw)
    for dotted, value in (overrides or {}).items():
        _set_dotted(cfg, dotted, value)
    return cfg


def _set_dotted(obj, dotted: str, value):
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, parts[-1])
    if cur is not None and not isinstance(cur, (dict, tuple)) and value is not None:
        value = type(cur)(value) if not isinstance(value, type(cur)) else value
    setattr(obj, parts[-1], value)
