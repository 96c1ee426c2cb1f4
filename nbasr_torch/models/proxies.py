"""Zero-cost NAS proxies for ranking architectures without training.

Counterpart of ``nbasr_tpu/models/proxies.py``:

  - ``grad_norm``  — L2 norm of the loss gradients at init,
  - ``snip``       — Σ |dL/dw * w| (connection sensitivity),
  - ``synflow``    — Σ |dR/dw * w| with R = Σ outputs, all-ones input and
                     |params|, on a model built with ``use_norm=False`` (the
                     reference's ``bn=False`` prunable copy),
  - ``num_params`` — the baseline: parameters counted, nothing launched.

Each proxy builds the rnn-free encoder (``use_rnn=False``, cell dropout 0,
``init_scheme='scaled'``) from ``torch.Generator().manual_seed(seed)`` on
the CPU, moves it to ``device`` (the card unless the caller asks for the
CPU) and scores it in eval mode: one forward and one backward through the
fused cell kernels and, for ``grad_norm`` and ``snip``, the CTC kernels of
``normalized_ctc_loss``.  The JAX init from ``PRNGKey(seed)`` cannot be
reproduced here, so building and scoring are apart: ``_score_<name>``
scores any model, one carrying the JAX init among them.  Every proxy takes
one batch (features and labels as the data pipeline gives them) and
returns a Python float; higher is predicted better.
"""

import torch

from ..ops.ctc import normalized_ctc_loss
from .asr import count_params, get_model, logits_length, resolve_device

__all__ = ['compute_proxy', 'PROXIES', 'grad_norm', 'snip', 'synflow',
           'num_params']


def _build_model(arch, seed, device, **model_kwargs):
    """The encoder a proxy scores, built from ``seed`` on ``device``."""
    return get_model(arch, use_rnn=False, cell_dropout=0.0,
                     init_scheme='scaled', device=device,
                     generator=torch.Generator().manual_seed(seed),
                     **model_kwargs)


def _grads(model, objective):
    """``(parameter, its gradient)`` for every parameter, the gradient None
    where the objective does not reach it (zero in JAX)."""
    params = list(model.parameters())
    grads = torch.autograd.grad(objective, params, allow_unused=True)
    return list(zip(params, grads))


def _loss(model, feats, fsize, labels, label_size):
    logits = model(feats, fsize)
    lsize = logits_length(fsize, feats.shape[1], logits.shape[1])
    return normalized_ctc_loss(logits, lsize, labels, label_size).mean()


def _sensitivity(grads):
    """Σ |g * p| over the parameters, each gradient with its own parameter."""
    with torch.no_grad():
        return float(sum((g * p).abs().sum() for p, g in grads
                         if g is not None))


def _norm(grads):
    """The L2 norm of all the gradients together."""
    return float(torch.sqrt(sum(g.square().sum() for _, g in grads
                                if g is not None)))


def _score_grad_norm(model, feats, fsize, labels, label_size):
    model.eval()
    return _norm(_grads(model, _loss(model, feats, fsize, labels,
                                     label_size)))


def _score_snip(model, feats, fsize, labels, label_size):
    model.eval()
    return _sensitivity(_grads(model, _loss(model, feats, fsize, labels,
                                            label_size)))


def _synflow_objective(model, feats, fsize):
    """R = Σ outputs on the all-ones input; replaces ``model``'s parameters
    by their absolute values, in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.abs_()
    return model(torch.ones_like(feats), fsize).sum()


def _score_synflow(model, feats, fsize, labels=None, label_size=None):
    """Replaces ``model``'s parameters by their absolute values, in place."""
    model.eval()
    return _sensitivity(_grads(model, _synflow_objective(model, feats, fsize)))


def grad_norm(arch, feats, fsize, labels, label_size, seed=0, device='cuda',
              **model_kwargs):
    model = _build_model(arch, seed, device, **model_kwargs)
    return _score_grad_norm(model, feats, fsize, labels, label_size)


def snip(arch, feats, fsize, labels, label_size, seed=0, device='cuda',
         **model_kwargs):
    model = _build_model(arch, seed, device, **model_kwargs)
    return _score_snip(model, feats, fsize, labels, label_size)


def synflow(arch, feats, fsize, labels=None, label_size=None, seed=0,
            device='cuda', **model_kwargs):
    """Σ |dR/dw * w| with R = Σ outputs on |params| and all-ones input;
    ``use_norm=False`` so that normalisation does not break path
    multiplicativity."""
    model = _build_model(arch, seed, device, use_norm=False, **model_kwargs)
    return _score_synflow(model, feats, fsize)


def num_params(arch, feats, fsize, labels=None, label_size=None, seed=0,
               device='cuda', **model_kwargs):
    """Counts the parameters of the model built on the CPU; launches
    nothing, so ``device`` is not used."""
    return float(count_params(get_model(arch, use_rnn=False, device='cpu',
                                        **model_kwargs)))


PROXIES = {
    'grad_norm': grad_norm,
    'snip': snip,
    'synflow': synflow,
    'num_params': num_params,
}


def compute_proxy(name, arch, batch_feats, feature_size, labels=None,
                  label_size=None, seed=0, device='cuda', **model_kwargs):
    """Evaluate proxy ``name`` for ``arch`` on one feature batch (numpy
    arrays or tensors) on ``device``; a missing card raises."""
    if name not in PROXIES:
        raise ValueError(f'Unknown proxy {name!r}; available: '
                         f'{sorted(PROXIES)}')
    device = resolve_device(device)

    def put(a):
        return None if a is None else torch.as_tensor(a).to(device)

    return PROXIES[name](arch, put(batch_feats), put(feature_size),
                         put(labels), put(label_size), seed=seed,
                         device=device, **model_kwargs)
