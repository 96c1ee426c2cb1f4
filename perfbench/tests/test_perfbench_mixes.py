"""The traffic generator: determinism under a seed, the same sizes for
every seed, and the reference's batching against the port's Loader."""

import json
import pathlib

import numpy as np
import pytest

from perfbench import traffic
from perfbench.reference import batches as ref_batches

MIXES = pathlib.Path(__file__).resolve().parents[1] / 'mixes'


def _mix(name, **kw):
    return {**json.loads((MIXES / f'{name}.json').read_text()), **kw}


def test_deck_is_a_function_of_the_seed():
    mix = _mix('timit-recipe', utterances=64)
    a1, l1 = traffic.deck(mix, 2 ** 31 + 5)
    a2, l2 = traffic.deck(mix, 2 ** 31 + 5)
    assert all(np.array_equal(x, y) for x, y in zip(a1, a2))
    assert all(np.array_equal(x, y) for x, y in zip(l1, l2))
    a3, _ = traffic.deck(mix, 7)
    assert not all(np.array_equal(x, y) for x, y in zip(a1, a3))


def test_deck_sizes_are_the_same_for_every_seed():
    mix = _mix('timit-recipe')
    sizes = [sorted(len(a) for a in traffic.deck(mix, s)[0]) for s in (1, 99)]
    assert sizes[0] == sizes[1]
    secs = np.array(sizes[0]) / traffic.SAMPLE_RATE
    assert secs.max() == pytest.approx(7.8)
    assert secs.min() >= 0.9
    assert np.median(secs) == pytest.approx(2.9, abs=0.01)
    _, labels = traffic.deck(mix, 1)
    assert all(1 <= l.min() and l.max() <= 48 for l in labels)


def test_streams_are_a_function_of_the_seed():
    mix = _mix('timit-sessions', bank_s=60, groups=3)
    l1, l2 = traffic.stream_lengths(mix, 3), traffic.stream_lengths(mix, 3)
    assert np.array_equal(l1, l2) and l1.shape == (3, 64)
    assert sorted(l1.ravel()) == sorted(traffic.stream_lengths(mix, 4).ravel())
    assert not np.array_equal(l1, traffic.stream_lengths(mix, 4))
    b = traffic.bank(mix, 3)
    assert len(b) == 60 * traffic.SAMPLE_RATE
    assert np.array_equal(b, traffic.bank(mix, 3))
    off = traffic.stream_offsets(mix, 3, l1, len(b))
    assert (off >= 0).all() and (off + l1 <= len(b)).all()


def test_sessions_are_ten_timit_sentences():
    mix = _mix('timit-sessions')
    secs = traffic.stream_lengths(mix, 1) / traffic.SAMPLE_RATE
    k = mix['sentences_per_stream']
    assert k == 10
    lo, hi = mix['duration_s']
    assert k * lo <= secs.min() and secs.max() <= k * hi
    assert secs.mean() == pytest.approx(
        k * traffic.sentence_seconds(mix, secs.size * k).mean(), rel=1e-4)


def test_reference_batches_are_the_loaders():
    from nbasr_torch.data.pipeline import ArrayDataset, Loader
    mix = _mix('timit-recipe', utterances=40)
    audio, labels = traffic.deck(mix, 11)
    loader = Loader(ArrayDataset(audio, labels), 8, bucket_batch_caps=(8, 6),
                    shuffle=True, seed=123)
    for epoch in range(2):
        mine = ref_batches.batches(audio, labels, 123, epoch, 300, (8, 6))
        theirs = list(loader)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
