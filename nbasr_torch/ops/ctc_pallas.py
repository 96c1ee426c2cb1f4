"""The CTC recursions on the card: the wrappers of the alpha and beta
kernels, their plain versions, their launch plan, and the forward-only
``ctc_loss_pallas``.

Port of ``nbasr_tpu/ops/ctc_pallas.py``, with its names: ``_alpha_kernel``
and ``_beta_kernel`` become ``nbasr_ctc_alpha`` and ``nbasr_ctc_beta`` of
``nbasr_torch/csrc/ctc.cu``, whose header states the bound and the design.
:func:`nbasr_torch.ops.ctc.ctc_loss` runs the alpha kernel in its forward
and the beta kernel in its backward.

:func:`alpha_scan_pallas` and :func:`beta_scan_pallas` take a CUDA tensor to
the kernel and a CPU tensor to the plain version (a loop over t of torch
ops, as the JAX package's scans), and nothing else: no fallback from one to
the other.  ``LAUNCHES`` counts the calls of each.  :func:`recursion_plan`
picks the kernel's path (a warp a row with the state in registers, or a
block a row for longer rows), pure and tested on the CPU; the kernel checks
the plan again.
"""

import ctypes
import functools

import torch

from . import _build

__all__ = ['alpha_scan_pallas', 'beta_scan_pallas', 'ctc_loss_pallas',
           'alpha_scan_reference', 'beta_scan_reference', 'recursion_plan',
           'LAUNCHES', 'reset_launches', 'S_WARP']

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
# the launch plan
# ---------------------------------------------------------------------------

#: The warp path's longest row.  A row of S states runs on
#: ceil(S / WARP_OWN) warps of one block, each holding 64 states in
#: registers (two a lane) of which it owns WARP_OWN; the other 16 it
#: borrows from its neighbour every WARP_HALO steps (``ctc.cu``).
S_WARP = 256
WARP_OWN = 48
WARP_HALO = 8
#: The block path: threads of a row's block at most (a thread a state
#: below), and em rows in its cp.async ring.
BLOCK_THREADS = 1024
BLOCK_RING = 2
#: The shared memory a block of an H100 may opt in to: the default of
#: :func:`recursion_plan` where no card is asked.
H100_SHARED_LIMIT = 232448
PLAN_FIELDS = ('path', 'warps', 'threads', 'ring')
_PATHS = ('warp', 'block')


def recursion_plan(T, B, S, smem_limit=H100_SHARED_LIMIT):
    """The kernels' launch for em ``[T, B, S]`` on a card whose blocks may
    opt in to ``smem_limit`` bytes of shared memory; one block a row.

    ``path``: ``'warp'`` for S <= S_WARP, ``warps`` = ceil(S / WARP_OWN)
    warps a row, the state in registers; ``'block'`` beyond, a block of
    ``threads`` with em through a cp.async ring of ``ring`` = BLOCK_RING
    rows and the state (``state``) in shared memory beside it where both
    fit, else in a global scratch (``'global'``); ``smem`` its dynamic
    shared memory in bytes.  A row whose ring does not fit is refused
    (ValueError).  T and B do not change the plan."""
    if T < 1 or B < 0 or S < 1:
        raise ValueError(f'no recursion of shape {(T, B, S)}')
    if S <= S_WARP:
        warps = -(-S // WARP_OWN)
        return dict(path='warp', warps=warps, threads=32 * warps, ring=0,
                    state='registers', smem=0)
    warps = min(BLOCK_THREADS // 32, -(-S // 32))
    plan = dict(path='block', warps=warps, threads=32 * warps, ring=BLOCK_RING)
    for state, words in (('shared', BLOCK_RING + 2), ('global', BLOCK_RING)):
        if 4 * S * words <= smem_limit:
            return dict(plan, state=state, smem=4 * S * words)
    raise ValueError(f'a row of {S} states: its em ring of {BLOCK_RING} rows '
                     f'does not fit {smem_limit} bytes of shared memory')


@functools.lru_cache(maxsize=None)
def _shared_limit(device):
    """The shared memory a block of a CUDA device may opt in to, read
    once."""
    with torch.cuda.device(device):
        limit = _build.function('ctc', 'nbasr_ctc_shared_limit', [])()
    if limit < 0:
        raise RuntimeError(f'could not read the shared memory limit of {device}')
    return limit


def device_plan(em):
    """:func:`recursion_plan` of a CUDA tensor's shape on its card."""
    return recursion_plan(*em.shape, _shared_limit(em.device))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ALPHA_ARGS = [ctypes.c_int] * 3 + [_P] * 6
_BETA_ARGS = [ctypes.c_int] * 3 + [_P] * 7


def _operands(em, masks):
    """Checks em and the ``[B, S]`` masks, taken as bool (nonzero is true,
    as the JAX wrappers' ``astype(jnp.float32)``) and contiguous; returns
    (T, B, S, masks)."""
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
        out.append((m if m.dtype == torch.bool else m != 0).contiguous())
    return T, B, S, out


def _launch_args(em, plan):
    """(plan ints, the global scratch of the state or None)."""
    ints = (ctypes.c_int * len(PLAN_FIELDS))(
        _PATHS.index(plan['path']), *(plan[k] for k in PLAN_FIELDS[1:]))
    _, B, S = em.shape
    state = (torch.empty((B, 2, S), dtype=torch.float32, device=em.device)
             if plan['state'] == 'global' else None)
    return ints, state


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_alpha(em, skip_ok):
    T, B, S, (skip,) = _operands(em, (skip_ok,))
    alphas = torch.empty_like(em)
    plan, state = _launch_args(em, device_plan(em))
    fn = _build.function('ctc', 'nbasr_ctc_alpha', _ALPHA_ARGS)
    with torch.cuda.device(em.device):
        err = fn(T, B, S, em.data_ptr(), skip.data_ptr(), alphas.data_ptr(),
                 _ptr(state), ctypes.cast(plan, _P), _stream(em))
    _build.check(err, 'ctc', 'CTC alpha')
    LAUNCHES['alpha']['kernel'] += 1
    return alphas


def _launch_beta(em, skip_ok, final_states):
    """The kernel takes the unshifted skip mask and reads skip[s+2]."""
    T, B, S, (skip, final) = _operands(em, (skip_ok, final_states))
    betas = torch.empty_like(em)
    plan, state = _launch_args(em, device_plan(em))
    fn = _build.function('ctc', 'nbasr_ctc_beta', _BETA_ARGS)
    with torch.cuda.device(em.device):
        err = fn(T, B, S, em.data_ptr(), skip.data_ptr(), final.data_ptr(),
                 betas.data_ptr(), _ptr(state), ctypes.cast(plan, _P),
                 _stream(em))
    _build.check(err, 'ctc', 'CTC beta')
    LAUNCHES['beta']['kernel'] += 1
    return betas
