"""Host-side batching: bucketing, fixed padded shapes, curriculum.

The port's own, jax-free copy of ``nbasr_tpu/data/pipeline.py``:

  - **Bucketing** by feature-frame count with boundary 300 and per-bucket
    batch sizes ``[min(bs,64), min(bs,48)]`` (reference
    ``training/tf/__init__.py:94-99``); every batch of a bucket is padded to
    the same shape, and partial batches are padded with zero rows plus a
    ``valid`` mask.
  - **Curriculum** as in the TF backend (``training/tf/__init__.py:42,
    120-137``): short-utterance passes ([16000 samples x2 epochs], [32000
    x2]) come before the endless full-data stream; epochs are counted in
    full-dataset steps.
  - **Host sharding** for data parallelism (``num_shards``,
    ``shard_index``): batches stay schedule-global (every shard walks the
    same batches, each batch size rounded up to ``num_shards``) and shard
    *s* materialises the contiguous rows ``[s*bs/n, (s+1)*bs/n)`` of each;
    the shards' rows, concatenated, are the unsharded schedule's batch.

Batches are dicts of numpy arrays:
  ``audio [B, S]`` float32, ``feature_size [B]`` int32 (true frame counts),
  ``labels [B, L]`` int32 (ids in [1, vocab)), ``label_size [B]`` int32,
  ``valid [B]`` float32 (0 for padding rows of partial batches).
For the same arguments the batches equal the JAX package's.
"""

import dataclasses

import numpy as np

from ..ops.frontend import FrontendConfig, num_frames
from ..utils import tracing
from . import load_train_stats
from .phonemes import PhonemeEncoder
from .timit import TimitSplit

__all__ = ['Loader', 'CurriculumStream', 'ArrayDataset',
           'make_synthetic_split', 'get_dataloaders', 'load_train_stats',
           'DEFAULT_CURRICULUM']

#: [(max_audio_samples, epochs)] — reference training/tf/__init__.py:42
DEFAULT_CURRICULUM = ((16000, 2), (32000, 2))


@dataclasses.dataclass
class ArrayDataset:
    """A split as parallel lists of float32 audio and int32 label arrays."""
    audio: list
    labels: list
    name: str = ''

    def __len__(self):
        return len(self.audio)

    @classmethod
    def from_timit(cls, root, split, encoder, remove_sa=True):
        ts = TimitSplit(root, split, encoder, remove_sa=remove_sa)
        return cls(ts.audio, ts.labels, name=split)


def make_synthetic_split(num_utts, seed=0, min_samples=4000, max_samples=48000,
                         vocab_size=49, name='synthetic'):
    """Deterministic fake TIMIT-like split: filtered-noise "speech" with
    random phoneme labels whose lengths scale with duration (the JAX
    package's generator, draw for draw)."""
    rng = np.random.RandomState(seed)
    audio, labels = [], []
    for _ in range(num_utts):
        n = int(rng.randint(min_samples, max_samples + 1))
        t = np.arange(n, dtype=np.float32)
        f0 = rng.uniform(80, 300)
        sig = (np.sin(2 * np.pi * f0 * t / 16000.0)
               * rng.uniform(0.05, 0.3)
               + rng.randn(n).astype(np.float32) * 0.02)
        audio.append(sig.astype(np.float32))
        n_labels = max(2, n // 1600)  # ~1 phoneme per 100ms
        labels.append(rng.randint(1, vocab_size, size=n_labels).astype(np.int32))
    return ArrayDataset(audio, labels, name=name)


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


class Loader:
    """Bucketed, statically shaped batch iterator over an :class:`ArrayDataset`."""

    def __init__(self, dataset, batch_size, frontend=None,
                 bucket_boundaries=(300,), bucket_batch_caps=(64, 48),
                 shuffle=False, seed=0, max_label_len=None,
                 num_shards=1, shard_index=0, max_audio_samples=None):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f'shard_index {shard_index} not in '
                             f'[0, {num_shards})')
        self.dataset = dataset
        self.frontend = frontend or FrontendConfig()
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

        indices = list(range(len(dataset)))
        if max_audio_samples:
            indices = [i for i in indices
                       if len(dataset.audio[i]) < max_audio_samples]
        if not indices:
            raise ValueError('Loader has no utterances after filtering')
        #: global indices, the same on every shard
        self.indices = indices
        self.num_shards = num_shards
        self.shard_index = shard_index

        frames = np.array([num_frames(len(dataset.audio[i]), self.frontend)
                           for i in indices])
        boundaries = list(bucket_boundaries)
        self.bucket_of = np.searchsorted(boundaries, frames, side='left')
        num_buckets = len(boundaries) + 1
        # global batch sizes, rounded up to a multiple of num_shards so that
        # every shard holds the same number of rows
        self.batch_sizes = [_round_up(min(batch_size, cap), num_shards)
                            for cap in bucket_batch_caps[:num_buckets]]
        self.local_batch_sizes = [bs // num_shards for bs in self.batch_sizes]

        # Static padded shapes per bucket: frames pad to the boundary (or the
        # split max, rounded up) and audio samples pad accordingly.
        cfg = self.frontend
        self.bucket_frames = []
        for b in range(num_buckets):
            in_bucket = frames[self.bucket_of == b]
            if b < len(boundaries):
                pad_frames = boundaries[b]
            else:
                pad_frames = _round_up(in_bucket.max() if in_bucket.size else 1, 16)
            self.bucket_frames.append(int(pad_frames))
        self.bucket_samples = [cfg.window + (f - 1) * cfg.hop
                               for f in self.bucket_frames]

        if max_label_len is None:
            max_label_len = _round_up(
                max(len(dataset.labels[i]) for i in indices), 8)
        self.max_label_len = int(max_label_len)

        # batches in one full pass (partial batches padded, so ceil)
        self.steps = sum(-(-int((self.bucket_of == b).sum()) // bs)
                         for b, bs in enumerate(self.batch_sizes))

    def _make_batch(self, idxs, bucket):
        """This shard's rows of one global batch: ``idxs`` are the global
        batch's dataset indices, and shard *s* owns the contiguous global
        rows ``[s*bs, (s+1)*bs)`` of the local batch size ``bs``."""
        ds, cfg = self.dataset, self.frontend
        bs = self.local_batch_sizes[bucket]
        lo = self.shard_index * bs
        S = self.bucket_samples[bucket]
        L = self.max_label_len
        audio = np.zeros((bs, S), np.float32)
        feature_size = np.zeros((bs,), np.int32)
        labels = np.zeros((bs, L), np.int32)
        label_size = np.zeros((bs,), np.int32)
        valid = np.zeros((bs,), np.float32)
        for row, i in enumerate(idxs):
            r = row - lo
            if not 0 <= r < bs:
                continue                      # another shard's row
            a, l = ds.audio[i], ds.labels[i]
            audio[r, :len(a)] = a[:S]
            feature_size[r] = num_frames(min(len(a), S), cfg)
            labels[r, :len(l)] = l[:L]
            label_size[r] = min(len(l), L)
            valid[r] = 1.0
        return {'audio': audio, 'feature_size': feature_size,
                'labels': labels, 'label_size': label_size, 'valid': valid}

    def __iter__(self):
        """One full pass (one epoch).  When shuffling, ready batches from
        different buckets are interleaved in random order, as the
        reference's ``bucket_by_sequence_length`` does."""
        order = np.array(self.indices)
        buckets = self.bucket_of
        rng = None
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            perm = rng.permutation(len(order))
            order, buckets = order[perm], buckets[perm]
            self._epoch += 1
        batches = []  # (bucket, row-index array)
        for b, bs in enumerate(self.batch_sizes):
            rows = order[buckets == b]
            for start in range(0, len(rows), bs):
                batches.append((b, rows[start:start + bs]))
        if rng is not None:
            rng.shuffle(batches)
        for b, rows in batches:
            with tracing.span('loader.batch'):
                batch = self._make_batch(rows, b)
            yield batch

    def __len__(self):
        return self.steps


class CurriculumStream:
    """TF-style curriculum: short-utterance passes, then the full loader
    cycled forever; ``steps`` per epoch are the full loader's."""

    def __init__(self, full_loader, curriculum_loaders):
        self.full = full_loader
        self.curriculum = curriculum_loaders
        self.steps = full_loader.steps

    def __iter__(self):
        for loader, epochs in self.curriculum:
            for _ in range(epochs):
                yield from loader
        while True:
            yield from self.full


def get_dataloaders(root, batch_size=64, curriculum=DEFAULT_CURRICULUM,
                    num_shards=1, shard_index=0, seed=0,
                    splits=('TRAIN', 'VAL', 'TEST')):
    """``(encoder, train, val, test)`` like the reference facade.  ``root``
    is a TIMIT directory or ``'synthetic[:N]'`` for the built-in fake corpus
    (N utterances in TRAIN, N//4 in VAL and TEST).  With ``num_shards`` > 1
    every split, the eval splits too, is this ``shard_index``'s shard of
    the schedule-global batches (:class:`Loader`)."""
    encoder = PhonemeEncoder(48)

    def make_dataset(split):
        if isinstance(root, str) and root.startswith('synthetic'):
            n = int(root.split(':', 1)[1]) if ':' in root else 128
            sizes = {'TRAIN': n, 'VAL': max(n // 4, 2), 'TEST': max(n // 4, 2)}
            seeds = {'TRAIN': 1, 'VAL': 2, 'TEST': 3}
            return make_synthetic_split(sizes[split], seed=seeds[split],
                                        name=split)
        return ArrayDataset.from_timit(root, split, encoder)

    loaders = []
    for split in splits:
        ds = make_dataset(split)
        is_train = split == 'TRAIN'
        shard = dict(num_shards=num_shards, shard_index=shard_index)
        full = Loader(ds, batch_size, shuffle=is_train, seed=seed, **shard)
        if is_train and curriculum:
            stages = []
            for max_samples, epochs in curriculum:
                try:
                    stages.append((Loader(
                        ds, batch_size, shuffle=True, seed=seed + 101,
                        max_label_len=full.max_label_len, **shard,
                        max_audio_samples=max_samples), epochs))
                except ValueError:
                    pass  # no utterances under this limit (tiny synthetic sets)
            loaders.append(CurriculumStream(full, stages))
        else:
            loaders.append(full)
    return (encoder, *loaders)
