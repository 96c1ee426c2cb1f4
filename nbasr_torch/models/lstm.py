"""LSTM head with a hoisted input projection.

Counterpart of ``nbasr_tpu/models/lstm.py`` ``FastLSTM``: ``x @ kernel +
bias`` for every timestep is one matmul outside the recurrence, and the
recurrence (``h @ recurrent`` plus the gates, frame by frame) is
:func:`nbasr_torch.ops.lstm_recurrence.lstm_recurrence`: one kernel launch
each way on the card, the plain loop on the CPU.  Keras layout — ``kernel
[F, 4H]``, ``recurrent [H, 4H]``, ``bias [4H]``, gate order (i, f, g, o),
forget-gate bias 1.  Products take ``compute_dtype`` operands with f32 sums,
as the JAX module's ``preferred_element_type``.
"""

import torch
from torch import nn

from ..ops.lstm_recurrence import lstm_recurrence
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
        T = x.shape[1]
        tracing.count('lstm.frames', T)
        dt = self.compute_dtype
        xw = (x.to(dt).float() @ self.kernel.to(dt).float()
              + self.bias).to(dt)
        c0 = h0 = None
        if initial_carry is not None:
            c0, h0 = (v.to(dt) for v in initial_carry)
        out, carry = lstm_recurrence(xw, self.recurrent.to(dt), c0, h0)
        return (out, carry) if return_carry else out
