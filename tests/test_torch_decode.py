"""The port's merged-prefix beam search against the JAX package's on the
CPU: ids and lengths equal, over seeds, at V=49 with W=12 and W=4, with
``logit_len < T`` and ``max_len``, on peaked logits that force repeats and
prefix merges, and on ties that only the JAX package's top-W order (lowest
index first) decides."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nbasr_tpu.ops.decode import beam_search_decode as jax_beam

from nbasr_torch.ops import decode
from nbasr_torch.ops.decode import beam_search_decode

V = 49


def _both(logits, logit_len, **kw):
    want = jax_beam(jnp.asarray(logits), jnp.asarray(logit_len), **kw)
    got = beam_search_decode(torch.tensor(logits), torch.tensor(logit_len),
                             **kw)
    return [np.asarray(a) for a in want], [t.numpy() for t in got]


def _assert_equal(want, got):
    (ids, lens), (gids, glens) = want, got
    assert gids.dtype == glens.dtype == np.int32
    np.testing.assert_array_equal(gids, ids)
    np.testing.assert_array_equal(glens, lens)


def _random(seed, B=6, T=40):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, V) * 3).astype(np.float32)
    logit_len = rng.randint(1, T + 1, size=B).astype(np.int32)
    logit_len[0] = T
    return logits, logit_len


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('beam_width', [12, 4])
def test_beam_matches_jax(seed, beam_width):
    """Random logits, rows of every length up to T."""
    logits, logit_len = _random(seed)
    want, got = _both(logits, logit_len, beam_width=beam_width)
    _assert_equal(want, got)
    assert got[0].shape == (6, 40) and got[1].max() > 0


def test_beam_max_len_matches_jax():
    logits, logit_len = _random(3)
    want, got = _both(logits, logit_len, beam_width=12, max_len=10)
    _assert_equal(want, got)
    assert got[0].shape == (6, 10) and got[1].max() == 10


def test_beam_merges_prefixes_like_jax():
    """Peaked logits on few classes: runs of a class (repeats) broken by
    blanks, so the prefixes of the beam collide and are merged, and the
    decoded sequences hold repeated labels."""
    rng = np.random.RandomState(9)
    B, T = 4, 60
    ids = rng.choice([0, 1, 2, 3], size=(B, T), p=[0.4, 0.2, 0.2, 0.2])
    ids = np.repeat(ids[:, ::3], 3, axis=1)[:, :T]
    logits = rng.randn(B, T, V).astype(np.float32) * 0.3 - 4.0
    logits[np.arange(B)[:, None], np.arange(T)[None], ids] = 2.0
    logits[:, :, :4] += rng.randn(B, T, 4).astype(np.float32)
    logit_len = np.array([T, T, 45, 20], np.int32)
    for width in (12, 4):
        want, got = _both(logits, logit_len, beam_width=width)
        _assert_equal(want, got)
    hyp, n = got
    assert any((hyp[b, 1:n[b]] == hyp[b, :n[b] - 1]).any() for b in range(B))


def test_beam_ties_go_to_the_lowest_index():
    """Equal logits everywhere: every extend ties with every other from the
    first frame on, and the JAX package keeps the lowest candidate indices
    (``jax.lax.top_k``).  ``torch.topk`` orders ties otherwise and decodes
    other ids here, so this case holds the stable top-W rule."""
    logits = np.zeros((2, 5, 6), np.float32)
    logit_len = np.array([5, 3], np.int32)
    for width in (12, 4):
        want, got = _both(logits, logit_len, beam_width=width)
        _assert_equal(want, got)
        np.testing.assert_array_equal(got[0][:, 0], [1, 1])

    def topk_order(x, dim, descending=False, stable=False):
        if not descending:
            return sort(x, dim=dim, stable=stable)
        return torch.topk(x, x.shape[dim], dim=dim)

    sort = torch.sort
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode.torch, 'sort', topk_order)
        other = [t.numpy() for t in beam_search_decode(
            torch.tensor(logits), torch.tensor(logit_len), beam_width=4)]
    assert not np.array_equal(other[0], want[0])


def test_hash_step_is_uint32_arithmetic():
    """The rolling hash in int64 keeps the low 32 bits of the uint32
    multiply-add, with no int64 overflow on the way."""
    h = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789], np.uint64)
    c = np.array([1, 48, 7, 0, 3], np.uint64)
    for mult in (decode._H1_MULT, decode._H2_MULT):
        want = (h * np.uint64(mult) + c) & np.uint64(0xFFFFFFFF)
        got = decode._hash_step(torch.tensor(h.astype(np.int64)), mult,
                                torch.tensor(c.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
