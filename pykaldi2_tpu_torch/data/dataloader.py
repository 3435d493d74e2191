"""Batchers: fixed-length chunking (CE) and sorted-bucket padding (SE).

Numpy copy of pykaldi2_tpu/data/dataloader.py for the PyTorch port: both
packages yield bit-identical batches (tests/test_torch_data.py).

Reference behavior: pykaldi2/data/dataloader.py ``ChunkDataloader`` /
``SeqDataloader`` (SURVEY.md §3.1). The reference used torch DataLoader +
DistributedSampler + PackedSequence; here the host emits fixed-shape numpy
batches from a small, static bucket inventory so every shape compiles exactly
once under jit (SURVEY.md §8 hard part 5), with rank-sharded utterance lists
replacing DistributedSampler.

Batch dicts (wave mode):
  wave   [B, S]    float32 waveform samples (int16 range)
  labels [B, T]    int32 pdf-ids (-1 where absent)
  mask   [B, T]    float32 1.0 on supervised frames
  num_frames [B]   int32
plus ``utt_ids`` (host-side list) for lattice bookkeeping in SE mode.
In feats mode ``feats [B, T, D]`` replaces ``wave``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Sequence

import numpy as np

_log = logging.getLogger("pykaldi2_tpu_torch.data")

from pykaldi2_tpu_torch.config import FrameOpts
from pykaldi2_tpu_torch.data.dataset import SpeechDataset


def chunk_samples(chunk_len: int, fo: FrameOpts) -> int:
    """Waveform samples covering ``chunk_len`` frames under snip-edges framing."""
    return (chunk_len - 1) * fo.window_shift + fo.window_size


def _utt_rng(seed: int, epoch: int, utt_id: str) -> np.random.RandomState:
    """Deterministic per-utterance RNG (stable under worker parallelism AND
    across processes — Python's salted str hash is not)."""
    import zlib

    h = zlib.crc32(f"{seed}|{epoch}|{utt_id}".encode()) & 0x7FFFFFFF
    return np.random.RandomState(h or 1)


def _iter_utts(ds: SpeechDataset, utt_ids, seed: int, epoch: int, num_workers: int):
    """Yield Utterances in order; ``num_workers`` threads overlap IO+simulation
    (the reference's DataLoader worker processes, SURVEY.md §4.3)."""
    if num_workers <= 0:
        for uid in utt_ids:
            yield ds.get(uid, _utt_rng(seed, epoch, uid))
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        lookahead = 2 * num_workers
        futures = []
        it = iter(utt_ids)
        for uid in it:
            futures.append(pool.submit(ds.get, uid, _utt_rng(seed, epoch, uid)))
            if len(futures) >= lookahead:
                break
        for uid in it:
            done = futures.pop(0)
            futures.append(pool.submit(ds.get, uid, _utt_rng(seed, epoch, uid)))
            yield done.result()
        for f in futures:
            yield f.result()


class ChunkDataloader:
    """CE-mode loader: split utterances into fixed ``chunk_len``-frame chunks.

    Chunking happens in the waveform domain at frame-shift boundaries, which
    yields bit-identical features to chunking in the feature domain (frame t
    of a chunk starting at frame c0 is exactly frame c0+t of the utterance).

    Semantics decision (SURVEY.md §9.3 open question, resolved for this
    framework): by default chunks are STATELESS and NON-OVERLAPPING — LSTM
    state is not carried across chunks and no context frames are shared.
    With the reference mount empty its exact behavior is unverifiable;
    stateless fixed chunks match the truncated-BPTT reading of the paper,
    and the chunk-level reservoir shuffle below makes carried state
    meaningless anyway (consecutive chunks of one utterance land in
    different batches).  ``chunk_overlap=k`` covers the other reading: each
    chunk after an utterance's first starts ``k`` frames early; those
    context frames warm the recurrent state up (mask=1, the model sees
    them) but are excluded from the loss (label −1), so every frame is
    supervised exactly once and emitted shapes stay static.
    """

    def __init__(
        self,
        dataset: SpeechDataset,
        batch_size: int,
        chunk_len: int = 80,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 0,
        chunk_shuffle_buffer: int = 1024,
        extras_fn=None,
        chunk_overlap: int = 0,
    ):
        """``chunk_shuffle_buffer``: when shuffling, chunks pass through a
        reservoir of this size so chunks of one utterance spread across
        batches (the reference shuffles at chunk granularity); 0 disables.
        ``extras_fn(utt_ids, n_samples) → dict of [B,...] arrays`` attaches
        per-row extras (speaker CMVN rows, VTLN warp ids, on-device
        simulation tensors — see pipeline.build_frontend); n_samples is the
        batch waveform length (None in feats mode); padding rows pass an
        empty utt_id."""
        self.ds = dataset
        self.batch_size = batch_size
        self.chunk_len = chunk_len
        self.rank, self.world_size = rank, world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.chunk_shuffle_buffer = chunk_shuffle_buffer
        self.extras_fn = extras_fn
        if not 0 <= chunk_overlap < chunk_len:
            raise ValueError(f"chunk_overlap {chunk_overlap} must be in "
                             f"[0, chunk_len={chunk_len})")
        self.chunk_overlap = chunk_overlap
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def num_batches(self, conservative: bool = False) -> int:
        """Metadata-only batch count for this rank (no audio is read).

        ``conservative=True`` undercounts when duration-changing simulation
        (speed perturbation) is active, so multihost ranks can truncate to a
        global minimum without deadlocking (see trainers' -multihost)."""
        ids, _ = self._rank_ids()
        shrink = 1.0
        sim = self.ds.simulate_fn
        if conservative and sim is not None and getattr(sim, "cfg", None) is not None:
            pc = sim.cfg.perturb
            if pc.use_speed:
                shrink = 1.0 / max(pc.speed_choices)
        stride = self.chunk_len - self.chunk_overlap
        chunks = 0
        for uid in ids:
            nf = int(self.ds.utt_num_frames(uid) * shrink)
            if nf > 0:
                chunks += 1 + max(0, -(-(nf - self.chunk_len) // stride))
        if self.drop_last or conservative:
            return chunks // self.batch_size
        return -(-chunks // self.batch_size)

    def _rank_ids(self):
        """This rank's utterances for the CURRENT epoch — must match __iter__
        exactly (shuffle before slicing), or multihost step counts lie."""
        order = np.arange(len(self.ds))
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        return [self.ds.utt_ids[i] for i in order[self.rank :: self.world_size]], rng

    def __iter__(self) -> Iterator[dict]:
        ordered_ids, rng = self._rank_ids()
        fo = self.ds.frame_opts
        T, S = self.chunk_len, chunk_samples(self.chunk_len, fo)
        feats_mode = self.ds.mode == "feats"
        buf: List[tuple] = []

        def emit():
            items = buf[: self.batch_size]
            del buf[: self.batch_size]
            b = len(items)
            labels = np.full((b, T), -1, np.int32)
            mask = np.zeros((b, T), np.float32)
            if feats_mode:
                dim = items[0][0].shape[1]
                xs = np.zeros((b, T, dim), np.float32)
            else:
                xs = np.zeros((b, S), np.float32)
            uids = []
            for i, (x, lab, clen, uid) in enumerate(items):
                xs[i, : x.shape[0]] = x
                # mask marks VALID FRAMES (model mask); supervision is
                # labels >= 0 (loss mask) — they differ for unlabeled data
                mask[i, :clen] = 1.0
                if lab is not None:
                    labels[i, : len(lab)] = lab
                uids.append(uid)
            key = "feats" if feats_mode else "wave"
            out = {key: xs, "labels": labels, "mask": mask}
            if self.extras_fn is not None:
                out.update(self.extras_fn(uids, None if feats_mode else S))
            return out

        pool: List[tuple] = []
        pool_cap = self.chunk_shuffle_buffer if self.shuffle else 0

        def push(item):
            """Route a chunk through the shuffle reservoir into the batch buf."""
            if pool_cap:
                pool.append(item)
                if len(pool) <= pool_cap:
                    return
                i = rng.randint(len(pool))
                pool[i], item = pool[-1], pool[i]
                pool.pop()
            buf.append(item)

        for utt in _iter_utts(self.ds, ordered_ids, self.seed, self.epoch, self.num_workers):
            x = utt.feats if feats_mode else utt.wave
            nf = utt.num_frames
            stride = T - self.chunk_overlap
            n_chunks = 1 + max(0, -(-(nf - T) // stride)) if nf > 0 else 0
            for k in range(n_chunks):
                c0 = k * stride
                clen = min(T, nf - c0)
                if feats_mode:
                    xc = x[c0 : c0 + clen]
                else:
                    s0 = c0 * fo.window_shift
                    xc = x[s0 : s0 + chunk_samples(clen, fo)]
                lab = utt.labels[c0 : c0 + clen] if utt.labels is not None else None
                if lab is not None and k > 0 and self.chunk_overlap:
                    lab = lab.copy()
                    lab[: self.chunk_overlap] = -1  # context frames: no loss
                push((xc, lab, clen, utt.utt_id))
                while len(buf) >= self.batch_size:
                    yield emit()
        if pool:
            rng.shuffle(pool)
            buf.extend(pool)
            pool.clear()
            while len(buf) >= self.batch_size:
                yield emit()
        if buf and not self.drop_last:
            # pad the tail batch to full batch_size with empty (masked) rows
            while len(buf) < self.batch_size:
                buf.append((np.zeros((0,) if not feats_mode else (0, buf[0][0].shape[1]), np.float32), None, 0, ""))
            yield emit()


@dataclasses.dataclass
class BucketSpec:
    """Static bucket inventory: frame-length boundaries + batch size per bucket.

    ``boundaries`` are max frame counts, ascending; an utterance goes in the
    first bucket whose boundary >= its frame count. ``batch_sizes`` may be a
    single int or one per bucket (longer buckets usually take smaller
    batches to keep memory flat).
    """

    boundaries: Sequence[int] = (200, 400, 800, 1600)
    batch_sizes: Sequence[int] | int = 16

    def batch_size(self, bucket: int) -> int:
        if isinstance(self.batch_sizes, int):
            return self.batch_sizes
        return self.batch_sizes[bucket]


class SeqDataloader:
    """SE-mode loader: whole utterances, sorted-bucket padded batches.

    Replaces the reference's sorted+padded batches feeding
    ``pack_padded_sequence`` (SURVEY.md §3.1 "Sequence dataloader"); bucket
    shapes are static so each bucket's train step compiles once.
    """

    def __init__(
        self,
        dataset: SpeechDataset,
        bucket_spec: BucketSpec = BucketSpec(),
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        extras_fn=None,
    ):
        self.ds = dataset
        self.spec = bucket_spec
        self.rank, self.world_size = rank, world_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.extras_fn = extras_fn
        self.epoch = 0
        # loader hygiene: utterances longer than the largest bucket are
        # skipped, and speed perturbation can push an utterance past its
        # bucket (truncated). Both are counted and logged — never silent.
        self.num_dropped = 0
        self.num_truncated = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def num_batches(self, conservative: bool = False) -> int:
        """Metadata-only batch count (full batches only when conservative)."""
        ids = list(self.ds.utt_ids)[self.rank :: self.world_size]
        counts = [0] * len(self.spec.boundaries)
        for uid in ids:
            nf = self.ds.utt_num_frames(uid)
            b = next((i for i, bound in enumerate(self.spec.boundaries) if nf <= bound), None)
            if b is not None:
                counts[b] += 1
        full = sum(c // self.spec.batch_size(i) for i, c in enumerate(counts))
        if conservative:
            return full
        return sum(-(-c // self.spec.batch_size(i)) for i, c in enumerate(counts) if c)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed + self.epoch)
        ids = list(self.ds.utt_ids)[self.rank :: self.world_size]
        if self.shuffle:
            rng.shuffle(ids)
        fo = self.ds.frame_opts
        feats_mode = self.ds.mode == "feats"
        nb = len(self.spec.boundaries)
        buckets: List[List] = [[] for _ in range(nb)]

        def emit(b: int):
            items = buckets[b]
            T = self.spec.boundaries[b]
            B = self.spec.batch_size(b)
            S = chunk_samples(T, fo)
            labels = np.full((B, T), -1, np.int32)
            mask = np.zeros((B, T), np.float32)
            nfs = np.zeros((B,), np.int32)
            utt_ids = []
            if feats_mode:
                dim = items[0].feats.shape[1]
                xs = np.zeros((B, T, dim), np.float32)
            else:
                xs = np.zeros((B, S), np.float32)
            # sort within batch by length, longest first (cheap locality win)
            items.sort(key=lambda u: -u.num_frames)
            for i, u in enumerate(items):
                # speed perturbation can push an utterance past its bucket
                nf = min(u.num_frames, T)
                if u.num_frames > T:
                    self.num_truncated += 1
                    _log.warning("utterance %s truncated %d → %d frames "
                                 "(bucket boundary %d)", u.utt_id, u.num_frames, T, T)
                nfs[i] = nf
                utt_ids.append(u.utt_id)
                if feats_mode:
                    xs[i, :nf] = u.feats[:nf]
                else:
                    ns = min(u.wave.shape[0], S)
                    xs[i, :ns] = u.wave[:ns]
                mask[i, :nf] = 1.0  # frame validity; supervision = labels >= 0
                if u.labels is not None:
                    labels[i, :nf] = u.labels[:nf]
            buckets[b] = []
            key = "feats" if feats_mode else "wave"
            out = {key: xs, "labels": labels, "mask": mask, "num_frames": nfs,
                   "utt_ids": utt_ids}
            if self.extras_fn is not None:
                padded_ids = utt_ids + [""] * (B - len(utt_ids))
                out.update(self.extras_fn(padded_ids, None if feats_mode else S))
            return out

        eligible = []
        dropped = []
        for uid in ids:
            nf = self.ds.utt_num_frames(uid)
            b = next((i for i, bound in enumerate(self.spec.boundaries) if nf <= bound), None)
            if b is None:
                dropped.append((uid, nf))
                continue
            eligible.append((uid, b))
        if dropped:
            self.num_dropped += len(dropped)
            _log.warning(
                "SeqDataloader dropped %d utterance(s) longer than the largest "
                "bucket (%d frames), e.g. %s (%d frames); raise "
                "BucketSpec.boundaries to include them",
                len(dropped), self.spec.boundaries[-1], dropped[0][0], dropped[0][1])
        utts = _iter_utts(self.ds, [u for u, _ in eligible], self.seed, self.epoch,
                          self.num_workers)
        for (uid, b), utt in zip(eligible, utts):
            buckets[b].append(utt)
            if len(buckets[b]) == self.spec.batch_size(b):
                yield emit(b)
        for b in range(nb):
            if buckets[b]:
                yield emit(b)
