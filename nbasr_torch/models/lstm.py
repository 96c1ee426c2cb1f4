"""LSTM head with a hoisted input projection.

Counterpart of ``nbasr_tpu/models/lstm.py`` ``FastLSTM``: ``x @ kernel +
bias`` for every timestep is one matmul outside the recurrence, and the
recurrence is a Python loop of ``h @ recurrent`` plus the gates.  Keras
layout — ``kernel [F, 4H]``, ``recurrent [H, 4H]``, ``bias [4H]``, gate
order (i, f, g, o), forget-gate bias 1.  Products take ``compute_dtype``
operands with f32 sums, as the JAX module's ``preferred_element_type``.
"""

import torch
from torch import nn

from ..utils import tracing
from .layers import kernel_initializer

__all__ = ['FastLSTM']


class FastLSTM(nn.Module):
    """Unidirectional LSTM over [B, T, F] -> [B, T, H]."""

    def __init__(self, in_features, hidden, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(kernel_initializer('reference')(
            (in_features, 4 * hidden), generator))
        self.recurrent = nn.Parameter(nn.init.orthogonal_(
            torch.empty(hidden, 4 * hidden), generator=generator))
        bias = torch.zeros(4 * hidden)
        bias[hidden:2 * hidden] = 1.0
        self.bias = nn.Parameter(bias)

    @tracing.module_span('lstm')
    def forward(self, x, initial_carry=None, return_carry=False):
        """[B, T, F] -> [B, T, H]; optionally seed/return the (c, h) carry.
        Traced as the span ``lstm``; the counter ``lstm.frames`` adds T."""
        B, T, _ = x.shape
        tracing.count('lstm.frames', T)
        dt = self.compute_dtype
        xw = (x.to(dt).float() @ self.kernel.to(dt).float()
              + self.bias).to(dt)
        rec = self.recurrent.to(dt).float()
        if initial_carry is None:
            c = h = torch.zeros((B, self.hidden), dtype=dt, device=x.device)
        else:
            c, h = (v.to(dt) for v in initial_carry)
        hs = []
        for t in range(T):
            gates = xw[:, t] + (h.float() @ rec).to(dt)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, dim=1)
        return (out, (c, h)) if return_carry else out
