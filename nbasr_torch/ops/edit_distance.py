"""Batched Levenshtein distance, PyTorch: counterpart of
``nbasr_tpu/ops/edit_distance.py`` (``edit_distance`` ``:24``,
``error_rate`` ``:61``).

The DP walks hypothesis tokens (rows); within a row the insertion chain is
the min-plus prefix recurrence ``C[j] = min_k<=j (B[k] + (j - k))``, one
``cummin`` over ``B[k] - k``, so a row is one vectorised pass over the
batch.  Sequences are 0-padded with explicit lengths; rows past
``hyp_len`` keep the previous row.
"""

import torch

__all__ = ['edit_distance', 'error_rate']


def edit_distance(hyp, hyp_len, ref, ref_len):
    """Levenshtein distance between 0-padded id sequences: ``hyp [B, M]``,
    ``hyp_len [B]``, ``ref [B, N]``, ``ref_len [B]`` -> ``[B]`` float32."""
    hyp = torch.as_tensor(hyp)
    device = hyp.device
    ref = torch.as_tensor(ref, device=device)
    hyp_len = torch.as_tensor(hyp_len, device=device)
    ref_len = torch.as_tensor(ref_len, device=device)
    B, M = hyp.shape
    N = ref.shape[1]
    cols = torch.arange(N + 1, dtype=torch.float32, device=device)
    prev = cols.expand(B, N + 1)                     # D[0][j] = j
    for i in range(1, M + 1):
        sub = (hyp[:, i - 1, None] != ref).float()
        cand = torch.minimum(prev[:, 1:] + 1.0, prev[:, :-1] + sub)
        base = torch.full((B, 1), float(i), device=device)
        run = torch.cummin(torch.cat([base, cand], dim=1) - cols, dim=1).values
        prev = torch.where((i <= hyp_len)[:, None], run + cols, prev)
    return prev.gather(1, ref_len.long()[:, None])[:, 0]


def error_rate(hyp, hyp_len, ref, ref_len):
    """Per-sample edit distance / reference length (numerator the raw
    distance, denominator the reference token count)."""
    d = edit_distance(hyp, hyp_len, ref, ref_len)
    ref_len = torch.as_tensor(ref_len, device=d.device)
    return d / torch.clamp(ref_len.to(d.dtype), min=1.0)
