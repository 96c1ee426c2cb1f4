"""Loss closure + conv L2, counterpart of ``nbasr_tpu/training/loss.py``.

Reference contracts: the normalised CTC loss closure
(``training/tf/trainer.py:30-53``: per-sample ÷(logit_len+1), mean over the
valid rows, a metrics dict of (numerator, denominator) pairs) and the L2 of
every conv kernel with Keras' 0.01 (``model/tf/ops.py:24``), squared.
"""

from torch import nn

from ..ops.ctc import normalized_ctc_loss

__all__ = ['get_loss', 'conv_l2', 'L2_COEFF']

L2_COEFF = 0.01


def _is_conv_kernel(name):
    """The port's names for the JAX package's selection (``loss.py:30-35``):
    a block conv's ``conv.weight`` and a cell conv's ``conv_kernel_grouped``."""
    return name.endswith('.conv.weight') or name.endswith('conv_kernel_grouped')


def conv_l2(params):
    """0.01 * the sum of squared conv kernels; ``params`` is a module or a
    ``{name: tensor}`` mapping."""
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    total = 0.0
    for name, p in items:
        if _is_conv_kernel(name):
            total = total + p.float().square().sum()
    return L2_COEFF * total


def get_loss():
    """``loss(logits, logits_size, encodeds, encodeds_size, metrics=None,
    valid=None, denominator=None)`` -> the mean normalised CTC loss over the
    valid rows; a ``metrics`` dict receives ``{'ctc_loss': (sum, count)}``
    (detached).  ``valid`` masks the padding rows of partial batches.
    ``denominator`` replaces this batch's count of valid rows: under data
    parallelism, the global batch's (the JAX trainer's psum'd denominator,
    ``nbasr_tpu/training/trainer.py:190-196``)."""

    def loss(logits, logits_size, encodeds, encodeds_size, metrics=None,
             valid=None, denominator=None):
        per_sample = normalized_ctc_loss(logits, logits_size, encodeds,
                                         encodeds_size)
        if valid is None:
            valid = per_sample.new_ones(per_sample.shape)
        per_sample = per_sample * valid
        if metrics is not None:
            metrics['ctc_loss'] = (per_sample.detach().sum(), valid.sum())
        if denominator is None:
            denominator = valid.sum()
        return per_sample.sum() / denominator.clamp(min=1.0)

    return loss
