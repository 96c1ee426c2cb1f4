"""CTC loss, PyTorch: counterpart of ``nbasr_tpu/ops/ctc.py``.

Same contract as the JAX package's: ``blank = 0``; labels are 1-based ids,
0-padded; inputs are unnormalised logits (log-softmax applied inside);
per-sample losses, with the reference's ``/(logit_length + 1)``
normalisation (``training/tf/metrics/ctc.py:27-28``) in
:func:`normalized_ctc_loss`.  The JAX package computes the recursion as XLA
scans, outside any Pallas kernel, so here ``F.ctc_loss`` on ``log_softmax``
computes it: frames past ``logit_len`` contribute nothing and get a zero
gradient, and ``zero_infinity`` zeroes the loss and the gradient of an
impossible alignment, as the JAX package's ``jnp.where`` does.
"""

import torch
import torch.nn.functional as F

__all__ = ['ctc_loss', 'normalized_ctc_loss']


def ctc_loss(logits, logit_len, labels, label_len, blank=0,
             zero_infinity=False):
    """``[B, T, V]`` logits -> ``[B]`` f32 CTC negative log-likelihoods.
    ``logit_len [B]`` true frame counts, ``labels [B, U]`` 0-padded ids,
    ``label_len [B]`` true label counts.  An impossible alignment gives
    ``inf`` (0 with ``zero_infinity``)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    device = logits.device
    return F.ctc_loss(log_probs, torch.as_tensor(labels, device=device).long(),
                      torch.as_tensor(logit_len, device=device).long(),
                      torch.as_tensor(label_len, device=device).long(),
                      blank=blank, reduction='none',
                      zero_infinity=zero_infinity)


def normalized_ctc_loss(logits, logit_len, labels, label_len, blank=0,
                        zero_infinity=True):
    """Reference-normalised per-sample loss: nll / (logit_len + 1)
    (``get_normalized_ctc_loss_without_reduce``,
    ``training/tf/metrics/ctc.py:10-36``); ``zero_infinity`` replaces an
    impossible alignment's loss by 0 (torch ``trainer.py:39``)."""
    loss = ctc_loss(logits, logit_len, labels, label_len, blank,
                    zero_infinity=zero_infinity)
    logit_len = torch.as_tensor(logit_len, device=loss.device)
    return loss / (logit_len + 1).to(loss.dtype)
