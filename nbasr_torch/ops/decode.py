"""CTC greedy decoding, PyTorch (counterpart of ``nbasr_tpu/ops/decode.py``
``greedy_decode``; blank = 0)."""

import torch

__all__ = ['greedy_decode']


def greedy_decode(logits, logit_len, blank=0):
    """[B, T, V] logits -> ([B, T] 0-padded label ids, [B] lengths), both
    int32: per-frame argmax → collapse repeats → drop blanks → left-compact."""
    ids = logits.argmax(dim=-1).to(torch.int32)
    T = ids.shape[1]
    logit_len = torch.as_tensor(logit_len, device=ids.device)
    valid = torch.arange(T, device=ids.device)[None, :] < logit_len[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    drop = (~keep).to(torch.uint8)
    order = torch.argsort(drop, dim=1, stable=True)
    packed = torch.where(torch.sort(drop, dim=1, stable=True).values.bool(),
                         torch.zeros_like(ids), ids.gather(1, order))
    return packed, keep.sum(dim=1).to(torch.int32)
