"""The recipe's batching, written out for the reference: utterances
bucketed at 300 frames (``boundary``), 64 rows a batch at or under it
and 48 above (``caps``); the short bucket padded to the boundary, the
long one to its longest utterance rounded up to 16 frames; labels padded
to the longest label sequence rounded up to 8; a partial batch padded
with empty rows that are not valid.  Each epoch ``e`` shuffles with ``numpy.random.RandomState(seed +
e)``: a permutation of the utterances, the batches of each bucket in that
order, then a shuffle of the list of batches."""

import numpy as np

from .frontend import HOP, WINDOW, num_frames

__all__ = ['batches']

BOUNDARY, CAPS = 300, (64, 48)


def _round_up(x, m):
    return -(-int(x) // m) * m


def batches(audio, labels, seed, epoch=0, boundary=BOUNDARY, caps=CAPS):
    """The batches of epoch ``epoch`` (from 0), in order, as dicts of
    numpy arrays: ``audio``, ``feature_size``, ``labels``, ``label_size``,
    ``valid``."""
    frames = np.array([num_frames(len(a)) for a in audio])
    bucket_of = np.searchsorted([boundary], frames, side='left')
    long = frames[bucket_of == 1]
    pad_frames = [boundary, _round_up(long.max() if long.size else 1, 16)]
    samples = [WINDOW + (f - 1) * HOP for f in pad_frames]
    L = _round_up(max(len(l) for l in labels), 8)
    rng = np.random.RandomState(seed + epoch)
    perm = rng.permutation(len(audio))
    order, buckets = np.arange(len(audio))[perm], bucket_of[perm]
    out = []
    for b, bs in enumerate(caps):
        rows = order[buckets == b]
        out += [(b, rows[i:i + bs]) for i in range(0, len(rows), bs)]
    rng.shuffle(out)
    result = []
    for b, rows in out:
        bs, S = caps[b], samples[b]
        batch = {'audio': np.zeros((bs, S), np.float32),
                 'feature_size': np.zeros(bs, np.int32),
                 'labels': np.zeros((bs, L), np.int32),
                 'label_size': np.zeros(bs, np.int32),
                 'valid': np.zeros(bs, np.float32)}
        for r, i in enumerate(rows):
            a, l = audio[i], labels[i]
            batch['audio'][r, :min(len(a), S)] = a[:S]
            batch['feature_size'][r] = num_frames(min(len(a), S))
            batch['labels'][r, :len(l)] = l[:L]
            batch['label_size'][r] = min(len(l), L)
            batch['valid'][r] = 1.0
        result.append(batch)
    return result
