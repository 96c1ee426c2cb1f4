"""CTC loss, PyTorch: counterpart of ``nbasr_tpu/ops/ctc.py``.

Same contract as the JAX package's: ``blank = 0``; labels are 1-based ids,
0-padded; inputs are unnormalised logits (log-softmax applied inside, in
f32); per-sample losses, with the reference's ``/(logit_length + 1)``
normalisation (``training/tf/metrics/ctc.py:27-28``) in
:func:`normalized_ctc_loss`.

The same algorithm too: the emission log-probs of the 2U+1 extended-label
states are gathered once into ``[T, B, S]``, frames past ``logit_len``
emit blank with certainty (which leaves the likelihood unchanged), the
forward recursion gives the likelihood, and the gradient is the closed
form ``softmax - alignment posterior`` from the backward recursion, folded
onto the classes by a one-hot product.  The two recursions run in the
alpha and beta kernels of ``nbasr_torch/csrc/ctc.cu`` on the card and in
their plain versions on the CPU (:mod:`nbasr_torch.ops.ctc_pallas`).

One deliberate difference: an impossible alignment (loss ``+inf``) gets a
zero gradient here, where the JAX custom VJP gives NaN on that row's valid
frames; with :func:`normalized_ctc_loss` its loss is 0 as well.
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils import tracing
from .ctc_pallas import _NEG_INF, _log_add, alpha_scan_pallas, \
    beta_scan_pallas

__all__ = ['ctc_loss', 'normalized_ctc_loss', 'ctc_alignment_posteriors']


def _extended_labels(labels, blank):
    """[B, U] labels -> [B, 2U+1] blank-interleaved extended sequence."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank, dtype=torch.long,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _emission_logprobs(log_probs, ext, logit_len, blank):
    """[B, T, V] log-probs -> [T, B, S] emissions for the extended labels;
    frames past ``logit_len`` emit blank with certainty (0 for blank
    states, -1e30 otherwise)."""
    B, T, _ = log_probs.shape
    S = ext.shape[1]
    em = log_probs.gather(2, ext[:, None, :].expand(B, T, S))   # [B, T, S]
    is_blank = (ext == blank)[:, None, :]
    pad = (torch.arange(T, device=em.device)[None, :, None]
           >= logit_len[:, None, None])
    certain_blank = torch.where(is_blank, 0.0, _NEG_INF)
    em = torch.where(pad, certain_blank, em)
    return em.transpose(0, 1).contiguous()


def _transition_masks(ext, blank):
    """Allowed-transition masks: (from s-1) always, (from s-2) when the
    state is a non-blank label different from the label two back."""
    skip_ok = (ext != blank) & (ext != torch.roll(ext, 2, dims=1))
    skip_ok[:, :2] = False
    return skip_ok


def _final_states(label_len, S):
    """The states a path may end in, built as the JAX package builds them:
    ``2L`` and ``2L - 1``, the second set to ``L > 0``.  For ``L = 0`` both
    writes hit state 0 and the second clears it, so such a row has no final
    state and its gradient is 0, as in the JAX package."""
    B = label_len.shape[0]
    rows = torch.arange(B, device=label_len.device)
    end = 2 * label_len
    final = torch.zeros((B, S), dtype=torch.bool, device=label_len.device)
    final[rows, end] = True
    final[rows, (end - 1).clamp(min=0)] = label_len > 0
    return final


def _as_long(x, device):
    return torch.as_tensor(x, device=device).long()


def _forward(logits, logit_len, labels, label_len, blank):
    """The CTC forward: (log_probs, ext, em, skip_ok, alphas, logit_len,
    label_len, ll), the lengths as long tensors on the logits' device."""
    device = logits.device
    logit_len = _as_long(logit_len, device)
    label_len = _as_long(label_len, device)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    ext = _extended_labels(_as_long(labels, device), blank)
    em = _emission_logprobs(log_probs, ext, logit_len, blank)
    skip_ok = _transition_masks(ext, blank)
    alphas = alpha_scan_pallas(em, skip_ok)
    rows = torch.arange(ext.shape[0], device=device)
    last = alphas[-1]
    end = 2 * label_len
    ll = _log_add(last[rows, end],
                  torch.where(label_len > 0, last[rows, (end - 1).clamp(min=0)],
                              _NEG_INF))
    return log_probs, ext, em, skip_ok, alphas, logit_len, label_len, ll


def _posteriors(log_probs, ext, em, skip_ok, alphas, label_len, ll):
    """Per-frame class posteriors ``[B, T, V]``, folded from the state
    posteriors ``exp(alpha + beta - ll)`` by the one-hot product of the JAX
    package (deterministic, where a scatter-add on the card is not).  A row
    whose ``ll`` is not finite (an impossible alignment) gets 0, where the
    JAX package's ``exp(alpha + beta - ll)`` gives NaN."""
    betas = beta_scan_pallas(em, skip_ok, _final_states(label_len, em.shape[2]))
    ok = torch.isfinite(ll)
    gamma = torch.where(
        ok[None, :, None],
        torch.exp(alphas + betas - torch.where(ok, ll, 0.0)[None, :, None]),
        0.0)
    onehot = torch.nn.functional.one_hot(ext, log_probs.shape[-1]).to(
        gamma.dtype)
    return torch.einsum('tbs,bsv->btv', gamma, onehot)


class _CTCLoss(torch.autograd.Function):
    """The JAX custom VJP: forward through the alpha recursion, backward
    ``softmax * sum(posterior) - posterior`` from the beta recursion, zero on
    padded frames and on rows whose likelihood is not finite, times the
    cotangent, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, logit_len, labels, label_len, blank):
        with tracing.span('ctc.forward'):
            saved = _forward(logits, logit_len, labels, label_len, blank)
        ctx.save_for_backward(*saved)
        ctx.dtype = logits.dtype
        return -saved[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (log_probs, ext, em, skip_ok, alphas, logit_len, label_len,
         ll) = ctx.saved_tensors
        with tracing.span('ctc.backward'):
            post = _posteriors(log_probs, ext, em, skip_ok, alphas, label_len,
                               ll)
            dlogits = torch.exp(log_probs) * post.sum(-1, keepdim=True) - post
            T = log_probs.shape[1]
            pad = (torch.arange(T, device=ll.device)[None, :, None]
                   >= logit_len[:, None, None])
            dlogits = torch.where(pad, 0.0, dlogits) * g[:, None, None]
            return dlogits.to(ctx.dtype), None, None, None, None


def ctc_loss(logits, logit_len, labels, label_len, blank=0):
    """``[B, T, V]`` logits -> ``[B]`` f32 CTC negative log-likelihoods.
    ``logit_len [B]`` true frame counts (<= T), ``labels [B, U]`` 1-based
    ids, 0-padded, ``label_len [B]`` true label counts (<= U).  An
    impossible alignment gives ``+inf`` and a zero gradient.
    Differentiable with respect to ``logits``."""
    return _CTCLoss.apply(logits, logit_len, labels, label_len, blank)


def ctc_alignment_posteriors(logits, logit_len, labels, label_len, blank=0):
    """Per-frame label posteriors ``[B, T, V]`` (diagnostics, forced
    alignment)."""
    with torch.no_grad():
        log_probs, ext, em, skip_ok, alphas, _, label_len, ll = _forward(
            logits, logit_len, labels, label_len, blank)
        return _posteriors(log_probs, ext, em, skip_ok, alphas, label_len, ll)


def normalized_ctc_loss(logits, logit_len, labels, label_len, blank=0,
                        zero_infinity=True):
    """Reference-normalised per-sample loss: nll / (logit_len + 1)
    (``get_normalized_ctc_loss_without_reduce``,
    ``training/tf/metrics/ctc.py:10-36``).  ``zero_infinity`` replaces a
    loss at or above 1e24, an impossible alignment's, by 0 (torch
    ``trainer.py:39``)."""
    loss = ctc_loss(logits, logit_len, labels, label_len, blank)
    logit_len = torch.as_tensor(logit_len, device=loss.device)
    loss = loss / (logit_len + 1).to(loss.dtype)
    if zero_infinity:
        loss = torch.where(loss >= -_NEG_INF / 1e6, 0.0, loss)
    return loss
