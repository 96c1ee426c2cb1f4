"""The one traffic generator: it reads a mix's parameters
(``perfbench/mixes/<name>.json``) and makes, from ``--seed``, what that
mix sends.  Every seed sends the same sizes: only the content and the
order change with it.

- ``sentence_seconds(mix, n)``: ``n`` sentence durations, the quantiles
  of a log-normal (``duration_median_s``, ``duration_sigma``) at ``(k +
  0.5) / n``, clipped to ``duration_s`` and the longest set to its upper
  end.
- ``deck(mix, seed)``: a training deck of ``utterances`` such sentences in
  seeded order; each has ``phones_per_s`` labels (at least 2) drawn from
  ``phone_ids``; the audio is speech-like noise: a sine at a drawn
  ``f0_hz`` and ``amplitude`` plus white noise of std ``noise``.
- ``stream_lengths(mix, seed)`` and ``bank(mix, seed)``: the serving
  streams' lengths, each a session of ``sentences_per_stream`` such
  sentences back to back (the sessions are the same for every seed), in
  seeded order, grouped ``streams`` at a time; the audio bank they read
  from, segments of ``segment_s`` seconds of the same speech-like noise;
  each stream reads the bank from a seeded offset.
"""

import math

import numpy as np

__all__ = ['SAMPLE_RATE', 'rng', 'sentence_seconds', 'deck', 'stream_lengths',
           'bank', 'stream_offsets']

SAMPLE_RATE = 16000


def rng(seed, salt):
    """A numpy generator of ``seed`` (any non-negative int) for one use."""
    return np.random.default_rng([int(seed), salt])


def _speech(r, lengths, f0, amp, noise):
    """Concatenated utterances of ``lengths`` samples: a sine per
    utterance plus white noise, float32."""
    n = int(np.sum(lengths))
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    t = np.arange(n, dtype=np.float64) - np.repeat(starts, lengths)
    freq = np.repeat(r.uniform(*f0, size=len(lengths)), lengths)
    gain = np.repeat(r.uniform(*amp, size=len(lengths)), lengths)
    sig = np.sin(2 * np.pi * freq * t / SAMPLE_RATE) * gain
    sig += r.standard_normal(n) * noise
    return sig.astype(np.float32), starts


def sentence_seconds(mix, n):
    """``n`` sentence durations in seconds, ascending."""
    from statistics import NormalDist
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(v) for v in q])
    dur = mix['duration_median_s'] * np.exp(mix['duration_sigma'] * z)
    dur = np.clip(dur, *mix['duration_s'])
    dur[-1] = mix['duration_s'][1]
    return dur


def deck(mix, seed):
    """``(audio list, labels list)`` of the training deck."""
    n = mix['utterances']
    r = rng(seed, 1)
    dur = sentence_seconds(mix, n)[r.permutation(n)]
    lengths = np.round(dur * SAMPLE_RATE).astype(np.int64)
    sig, starts = _speech(r, lengths, mix['f0_hz'], mix['amplitude'],
                          mix['noise'])
    audio = [sig[s:s + m] for s, m in zip(starts, lengths)]
    lo, hi = mix['phone_ids']
    labels = [r.integers(lo, hi + 1, size=max(2, int(round(
        d * mix['phones_per_s'])))).astype(np.int32) for d in dur]
    return audio, labels


def stream_lengths(mix, seed):
    """``[groups, streams]`` stream lengths in samples."""
    g, s, k = mix['groups'], mix['streams'], mix['sentences_per_stream']
    dur = sentence_seconds(mix, g * s * k)
    sessions = dur[rng(0, 7).permutation(g * s * k)].reshape(g * s, k)
    secs = sessions.sum(axis=1)[rng(seed, 2).permutation(g * s)]
    return np.round(secs * SAMPLE_RATE).astype(np.int64).reshape(g, s)


def bank(mix, seed):
    """The serving audio bank, float32 samples."""
    r = rng(seed, 3)
    total = int(mix['bank_s'] * SAMPLE_RATE)
    lo, hi = mix['segment_s']
    n_seg = int(math.ceil(mix['bank_s'] / lo))
    seg = np.round(r.uniform(lo, hi, size=n_seg) * SAMPLE_RATE).astype(
        np.int64)
    seg = seg[:np.searchsorted(np.cumsum(seg), total) + 1]
    sig, _ = _speech(r, seg, mix['f0_hz'], mix['amplitude'], mix['noise'])
    return sig[:total]


def stream_offsets(mix, seed, lengths, bank_len):
    """Each stream's first sample in the bank, ``lengths``' shape."""
    r = rng(seed, 4)
    return (r.random(lengths.shape) * (bank_len - lengths)).astype(np.int64)
