"""The CTC recursions on the card: the wrappers of the alpha and beta
kernels, their plain versions, and the forward-only ``ctc_loss_pallas``.

Port of ``nbasr_tpu/ops/ctc_pallas.py``, with its names: ``_alpha_kernel``
and ``_beta_kernel`` become ``nbasr_ctc_alpha`` and ``nbasr_ctc_beta`` of
``nbasr_torch/csrc/ctc.cu``, whose header states the bound and the design.
:func:`nbasr_torch.ops.ctc.ctc_loss` runs the alpha kernel in its forward
and the beta kernel in its backward.

:func:`alpha_scan_pallas` and :func:`beta_scan_pallas` take a CUDA tensor to
the kernel and a CPU tensor to the plain version (a loop over t of torch
ops, as the JAX package's scans), and nothing else: no fallback from one to
the other.  ``LAUNCHES`` counts the calls of each.
"""

import ctypes

import torch

from . import _build

__all__ = ['alpha_scan_pallas', 'beta_scan_pallas', 'ctc_loss_pallas',
           'alpha_scan_reference', 'beta_scan_reference', 'LAUNCHES',
           'reset_launches']

_NEG_INF = -1e30

#: Calls of each kernel (``'kernel'``) and of its plain version
#: (``'plain'``) since the last :func:`reset_launches`.
LAUNCHES = {name: {'kernel': 0, 'plain': 0} for name in ('alpha', 'beta')}


def reset_launches():
    for counts in LAUNCHES.values():
        counts.update(kernel=0, plain=0)


def _log_add(a, b):
    """log(exp(a) + exp(b)) with the JAX package's floor handling: the max
    is taken as 0 where it is at or below -1e30, so two floors give -inf."""
    mx = torch.maximum(a, b)
    mx = torch.where(mx <= _NEG_INF, torch.zeros_like(mx), mx)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _shift(x, k):
    """``x[:, s - k]`` for k > 0, ``x[:, s + |k|]`` for k < 0, -1e30 where
    that falls outside the row."""
    fill = torch.full_like(x[:, :abs(k)], _NEG_INF)
    if k > 0:
        return torch.cat([fill, x[:, :-k]], dim=1)
    return torch.cat([x[:, -k:], fill], dim=1)


def _skip_next(skip_ok):
    """The skip into s+2, ``skip_ok[:, s + 2]`` (False in the last two
    states): the beta recursion's pre-shifted mask."""
    return torch.cat([skip_ok[:, 2:], torch.zeros_like(skip_ok[:, :2])], dim=1)


def _device_kind(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the CTC recursions run on cuda or cpu, not {x.device}')
    return x.device.type


# ---------------------------------------------------------------------------
# entry points: the kernel for a CUDA tensor, the plain version for a CPU one
# ---------------------------------------------------------------------------

def alpha_scan_pallas(em, skip_ok):
    """``[T, B, S]`` f32 emissions + ``[B, S]`` bool skip mask -> the stacked
    alphas ``[T, B, S]`` f32."""
    if _device_kind(em) == 'cpu':
        return alpha_scan_reference(em, skip_ok)
    return _launch_alpha(em, skip_ok)


def beta_scan_pallas(em, skip_ok, final_states):
    """The backward recursion: ``[T, B, S]`` emissions, the unshifted
    ``[B, S]`` skip mask and the ``[B, S]`` bool final states -> the stacked
    betas ``[T, B, S]`` f32 (beta of step t holds no emission of its own)."""
    if _device_kind(em) == 'cpu':
        return beta_scan_reference(em, skip_ok, final_states)
    return _launch_beta(em, skip_ok, final_states)


def ctc_loss_pallas(logits, logit_len, labels, label_len, blank=0):
    """Per-sample CTC nll through the alpha recursion, forward only; the
    gradient is :func:`nbasr_torch.ops.ctc.ctc_loss`'s."""
    from .ctc import _forward          # ops.ctc imports this module
    with torch.no_grad():
        return -_forward(logits, logit_len, labels, label_len, blank)[-1]


# ---------------------------------------------------------------------------
# plain versions: a loop over t of torch ops, as the JAX package's scans
# ---------------------------------------------------------------------------

def alpha_scan_reference(em, skip_ok):
    """The plain version of :func:`alpha_scan_pallas`."""
    LAUNCHES['alpha']['plain'] += 1
    S = em.shape[2]
    cols = torch.arange(S, device=em.device)
    alpha = torch.where(cols < 2, em[0], _NEG_INF)
    out = [alpha]
    for em_t in em[1:]:
        prev = _log_add(alpha, _shift(alpha, 1))
        prev = torch.where(skip_ok, _log_add(prev, _shift(alpha, 2)), prev)
        alpha = prev + em_t
        out.append(alpha)
    return torch.stack(out)


def beta_scan_reference(em, skip_ok, final_states):
    """The plain version of :func:`beta_scan_pallas`."""
    LAUNCHES['beta']['plain'] += 1
    skip_next = _skip_next(skip_ok)
    beta = torch.where(final_states, 0.0, _NEG_INF).to(em.dtype)
    out = [beta]
    for em_next in em[1:].flip(0):
        inc = beta + em_next
        nxt = _log_add(inc, _shift(inc, -1))
        beta = torch.where(skip_next, _log_add(nxt, _shift(inc, -2)), nxt)
        out.append(beta)
    return torch.stack(out[::-1])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ALPHA_ARGS = [ctypes.c_int] * 3 + [_P] * 5
_BETA_ARGS = [ctypes.c_int] * 3 + [_P] * 6


def _operands(em, masks):
    """Checks em and casts the ``[B, S]`` masks to contiguous f32 (as the
    JAX wrappers' ``astype(jnp.float32)``); returns (T, B, S, masks)."""
    if em.dim() != 3 or em.dtype != torch.float32 or not em.is_contiguous():
        raise ValueError(f'em: expected a contiguous float32 [T, B, S] '
                         f'tensor, got {em.dtype} {tuple(em.shape)}')
    T, B, S = em.shape
    if T < 1 or S < 1:
        raise ValueError(f'em: empty time or state axis, {tuple(em.shape)}')
    out = []
    for m in masks:
        if tuple(m.shape) != (B, S) or m.device != em.device:
            raise ValueError(f'mask: expected [B, S] = {(B, S)} on '
                             f'{em.device}, got {tuple(m.shape)} on {m.device}')
        out.append(m.to(torch.float32).contiguous())
    return T, B, S, out


def _state(B, S, device):
    """The scratch of the recursion's state where it does not fit the shared
    memory the kernel asks for, else None."""
    limit = _build.function('ctc', 'nbasr_ctc_shared_state_bytes', [],
                            ctypes.c_longlong)()
    if 2 * S * 4 <= limit:
        return None
    return torch.empty((B, 2, S), dtype=torch.float32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_alpha(em, skip_ok):
    T, B, S, (skip,) = _operands(em, (skip_ok,))
    alphas = torch.empty_like(em)
    state = _state(B, S, em.device)
    fn = _build.function('ctc', 'nbasr_ctc_alpha', _ALPHA_ARGS)
    with torch.cuda.device(em.device):
        err = fn(T, B, S, em.data_ptr(), skip.data_ptr(), alphas.data_ptr(),
                 _ptr(state), _stream(em))
    _build.check(err, 'ctc', 'CTC alpha')
    LAUNCHES['alpha']['kernel'] += 1
    return alphas


def _launch_beta(em, skip_ok, final_states):
    T, B, S, (skip_next, final) = _operands(
        em, (_skip_next(skip_ok), final_states))
    betas = torch.empty_like(em)
    state = _state(B, S, em.device)
    fn = _build.function('ctc', 'nbasr_ctc_beta', _BETA_ARGS)
    with torch.cuda.device(em.device):
        err = fn(T, B, S, em.data_ptr(), skip_next.data_ptr(),
                 final.data_ptr(), betas.data_ptr(), _ptr(state), _stream(em))
    _build.check(err, 'ctc', 'CTC beta')
    LAUNCHES['beta']['kernel'] += 1
    return betas
