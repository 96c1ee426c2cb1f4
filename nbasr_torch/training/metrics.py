"""Streaming ratio metrics as (numerator, denominator) pairs, counterpart of
``nbasr_tpu/training/metrics.py``: pairs accumulate on the device, so an
epoch average is exactly sample-weighted and is read to the host once."""

import torch

__all__ = ['zeros_like_metrics', 'accumulate', 'ratios', 'METRIC_KEYS']

METRIC_KEYS = ('ctc_loss', 'wer', 'ler')


def zeros_like_metrics(keys=METRIC_KEYS, device=None):
    """Fresh accumulator: ``{key: (0.0, 0.0)}`` as f32 tensors."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {k: (zero, zero) for k in keys}


def accumulate(acc, update):
    """Add a step's (num, den) pairs into the accumulator, on the device."""
    out = dict(acc)
    for k, (num, den) in update.items():
        num, den = num.detach().float(), den.detach().float()
        if k in out:
            n0, d0 = out[k]
            out[k] = (n0 + num, d0 + den)
        else:
            out[k] = (num, den)
    return out


def ratios(acc):
    """Python floats ``{key: num/den}``, 0 where den is 0; one host read."""
    if not acc:
        return {}
    pairs = torch.stack([torch.stack(p) for p in acc.values()]).cpu().tolist()
    return {k: n / d if d else 0.0 for k, (n, d) in zip(acc, pairs)}
