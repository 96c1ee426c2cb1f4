"""CTC decoders, PyTorch: counterpart of ``nbasr_tpu/ops/decode.py``, greedy
and merged-prefix beam search (blank = 0).

The JAX package runs both as XLA programs, outside any Pallas kernel, so
here they are torch ops on the logits' device, vectorised over the batch,
the beam search with a Python loop over the frames in place of the JAX
``scan``.
"""

import torch

__all__ = ['greedy_decode', 'beam_search_decode']

_NEG_INF = -1e30

# rolling-hash multipliers (odd constants; two independent 32-bit streams)
_H1_MULT = 2654435761
_H2_MULT = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def _log_add(a, b):
    mx = torch.maximum(a, b)
    mx = torch.where(mx <= _NEG_INF, torch.zeros_like(mx), mx)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _logsumexp(x, dim):
    """``jax.nn.logsumexp``: the max taken as 0 where it is not finite."""
    amax = x.amax(dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(x - amax).sum(dim)) + amax.squeeze(dim)


def _hash_step(h, mult, c):
    """``(h * mult + c) mod 2**32`` for int64 ``h`` in [0, 2**32): the
    product split at 16 bits of ``mult``, so no int64 product overflows."""
    lo = h * (mult & 0xFFFF)
    hi = ((h * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi + c) & _MASK32


def _left_compact(values, keep):
    """Move kept entries left along dim 1 (stable), zero the rest; returns
    (packed, kept counts) as int32."""
    drop = (~keep).to(torch.uint8)
    order = torch.argsort(drop, dim=1, stable=True)
    packed = torch.where(torch.sort(drop, dim=1, stable=True).values.bool(),
                         torch.zeros_like(values), values.gather(1, order))
    return packed.to(torch.int32), keep.sum(dim=1).to(torch.int32)


def greedy_decode(logits, logit_len, blank=0):
    """[B, T, V] logits -> ([B, T] 0-padded label ids, [B] lengths), both
    int32: per-frame argmax → collapse repeats → drop blanks → left-compact."""
    ids = logits.argmax(dim=-1).to(torch.int32)
    T = ids.shape[1]
    logit_len = torch.as_tensor(logit_len, device=ids.device)
    valid = torch.arange(T, device=ids.device)[None, :] < logit_len[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    return _left_compact(ids, keep)


def beam_search_decode(logits, logit_len, beam_width=12, max_len=None,
                       blank=0):
    """Merged-prefix CTC beam search: ``[B, T, V]`` logits -> (the top
    prefix ``[B, U]`` 0-padded, its length ``[B]``), both int32, ``U =
    max_len or T``.  The JAX package's algorithm step for step
    (``nbasr_tpu/ops/decode.py:65-194``), so the ids are equal:

      - each beam entry carries p_blank, p_nonblank, its last char and two
        32-bit rolling hashes of its prefix and of its parent (the prefix
        minus its last char);
      - an extend ``prefix_w + c`` equal to a stay ``prefix_w'`` is found by
        an O(W²) parent-hash match, merged into the stay and masked out;
      - the top W of the stays and extends, ties to the lowest index (as
        ``jax.lax.top_k``: a stable descending sort, where ``torch.topk``
        orders ties otherwise);
      - frames at or past ``logit_len`` leave the beam as it is;
      - backpointers, a reverse walk from the best beam, and a left
        compaction of the emitted chars.
    """
    ids, lengths, _ = _beam_search(logits, logit_len, beam_width, max_len,
                                   blank)
    return ids, lengths


def _beam_search(logits, logit_len, beam_width, max_len, blank):
    """:func:`beam_search_decode`'s ids and lengths, and the final ``[B, W]``
    log-probabilities of the beam entries (p_blank ⊕ p_nonblank)."""
    B, T, V = logits.shape
    U = max_len or T
    W = beam_width
    dev = logits.device
    lp = torch.log_softmax(logits, dim=-1).float()
    length = torch.as_tensor(logit_len, device=dev).long()

    last = torch.full((B, W), -1, dtype=torch.long, device=dev)
    h1, h2, h1p, h2p = (torch.zeros((B, W), dtype=torch.long, device=dev)
                        for _ in range(4))
    p_b = torch.full((B, W), _NEG_INF, device=dev)
    p_b[:, 0] = 0.0                                   # empty prefix, blank
    p_nb = torch.full((B, W), _NEG_INF, device=dev)
    chars = torch.arange(1, V, device=dev)            # non-blank chars
    iw = torch.arange(W, device=dev).expand(B, W)
    parents = torch.empty((T, B, W), dtype=torch.long, device=dev)
    emitted = torch.empty((T, B, W), dtype=torch.long, device=dev)

    for t in range(T):
        lp_t = lp[:, t]                                          # [B, V]
        lp_blank = lp_t[:, blank, None]
        lp_last = torch.where(last >= 0, lp_t.gather(1, last.clamp(min=0)),
                              _NEG_INF)
        p_tot = _log_add(p_b, p_nb)

        # stay candidates (same prefix): blank emission + repeat emission
        stay_pb = p_tot + lp_blank
        stay_pnb = p_nb + lp_last
        # extend candidates [B, W, V-1]
        ext_pnb = lp_t[:, None, 1:] + torch.where(
            chars[None, None, :] == last[:, :, None], p_b[:, :, None],
            p_tot[:, :, None])

        # merge extend(w, c) into stay(w') where prefix_w' == prefix_w + c
        match = ((h1[:, :, None] == h1p[:, None, :])
                 & (h2[:, :, None] == h2p[:, None, :])
                 & (last[:, None, :] >= 0)
                 & (p_tot[:, :, None] > _NEG_INF / 2))          # [B, Wx, Ws]
        last_onehot = (last.clamp(min=0)[:, :, None] - 1
                       == torch.arange(V - 1, device=dev))      # [B, Ws, V-1]
        ext_for_stay = torch.where(last_onehot[:, None], ext_pnb[:, :, None],
                                   _NEG_INF).amax(-1)           # [B, Wx, Ws]
        contrib = torch.where(match, ext_for_stay, _NEG_INF)
        stay_pnb = _log_add(stay_pnb, _logsumexp(contrib, dim=1))
        kill = torch.bmm(match.float(), last_onehot.float()) > 0.5
        ext_pnb = torch.where(kill, _NEG_INF, ext_pnb)

        # top-W over stays (fully merged) + extends (distinct)
        scores = torch.cat([_log_add(stay_pb, stay_pnb),
                            ext_pnb.reshape(B, -1)], dim=1)
        top_score, top_idx = torch.sort(scores, dim=1, descending=True,
                                        stable=True)
        top_score, top_idx = top_score[:, :W], top_idx[:, :W]
        alive = top_score > _NEG_INF / 2
        is_stay = top_idx < W
        w_sel = torch.where(is_stay, top_idx, (top_idx - W) // (V - 1))
        c_sel = torch.where(is_stay, -1, (top_idx - W) % (V - 1) + 1)

        new_pb = torch.where(alive & is_stay, stay_pb.gather(1, w_sel),
                             _NEG_INF)
        # an extend's total score is its p_nb (no blank mass yet)
        new_pnb = torch.where(
            alive, torch.where(is_stay, stay_pnb.gather(1, w_sel), top_score),
            _NEG_INF)
        new_last = torch.where(is_stay, last.gather(1, w_sel), c_sel)
        h1s, h2s = h1.gather(1, w_sel), h2.gather(1, w_sel)
        new_h1 = torch.where(is_stay, h1s, _hash_step(h1s, _H1_MULT, c_sel))
        new_h2 = torch.where(is_stay, h2s, _hash_step(h2s, _H2_MULT, c_sel))
        new_h1p = torch.where(is_stay, h1p.gather(1, w_sel), h1s)
        new_h2p = torch.where(is_stay, h2p.gather(1, w_sel), h2s)

        live = (t < length)[:, None]
        last, h1, h2, h1p, h2p, p_b, p_nb = (
            torch.where(live, new, old) for new, old in (
                (new_last, last), (new_h1, h1), (new_h2, h2), (new_h1p, h1p),
                (new_h2p, h2p), (new_pb, p_b), (new_pnb, p_nb)))
        # backpointers: identity and no emission on frozen frames
        parents[t] = torch.where(live, w_sel, iw)
        emitted[t] = torch.where(live, c_sel, -1)

    # the winning prefix from the backpointers (reverse walk)
    scores = _log_add(p_b, p_nb)
    idx = scores.argmax(dim=1, keepdim=True)                    # [B, 1]
    chars_out = torch.empty((B, T), dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        chars_out[:, t] = emitted[t].gather(1, idx)[:, 0]
        idx = parents[t].gather(1, idx)
    out, n = _left_compact(chars_out, chars_out >= 1)
    return out[:, :U], torch.clamp(n, max=U), scores
