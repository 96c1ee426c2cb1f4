"""Weights-only int8 post-training quantization for serving.

Counterpart of ``nbasr_tpu/quant.py``: symmetric int8 per output channel
for every matmul-class kernel (block convs, grouped cell convs, dense and
LSTM input kernels, the LSTM's recurrent kernel); biases and LayerNorm
parameters stay f32.  ``q = clip(round(w / s), -127, 127)`` with ``s =
max|w| / 127`` over everything but the output axis (1 where a channel is
all zero): one f32 division and a round half to even, as ``jnp.round``
does, so ``q`` and ``s`` are bit-equal to the JAX package's for the same
weights.

The trees here are the port's: a flat mapping from parameter names
(``'.'``-joined flax paths, as :mod:`nbasr_torch.convert` gives them) to
tensors, each quantized kernel becoming ``{'q': int8, 's': f32}``.  The
output axis is the layout's own: axis 0 of an ``nn.Conv``'s ``conv.weight
[cout, cin, K]``, the last axis of a grouped ``[K, ci, C]``, a dense ``[in,
out]`` and the LSTM's kernels; ``s`` keeps the kernel's rank.
:func:`save_quantized` writes the JAX package's ``.npz`` (``'/'``-joined
flax paths, ``#q``/``#s`` halves, ``conv/kernel`` in the WIO layout) and
:func:`load_quantized` reads one, so the files cross both ways.

Usage::

    qtree = quantize_tree(dict(model.named_parameters()))
    logits = quantized_apply(model, qtree, feats, sizes)
"""

import numpy as np
import torch
from torch.func import functional_call

from .convert import is_conv_param

__all__ = ['quantize_tree', 'dequantize_tree', 'quantized_apply',
           'quantized_size_bytes', 'save_quantized', 'load_quantized',
           'KERNEL_KEYS']

#: Parameter leaf names that hold matmul-class kernels, the JAX package's
#: (``kernel``: dense, LSTM input, ``nn.Conv``; ``conv_kernel_grouped``;
#: ``recurrent``) and the port's ``nn.Conv`` layout, ``conv.weight``.
KERNEL_KEYS = ('kernel', 'conv_kernel_grouped', 'recurrent', 'weight')


def _is_conv(name):
    """Whether ``name`` is an ``nn.Conv``'s weight in the port's ``[cout,
    cin, K]`` layout (:mod:`nbasr_torch.convert`'s one layout change)."""
    conv, leaf = is_conv_param(name)
    return conv and leaf == 'weight'


def _is_quantizable(name, t):
    leaf = name.rpartition('.')[2]
    if leaf == 'weight' and not _is_conv(name):
        return False
    return (leaf in KERNEL_KEYS and t.dim() >= 2
            and t.dtype in (torch.float32, torch.bfloat16))


def _quantize_leaf(w, axis):
    """Symmetric per-output-channel int8 along ``axis``: w ≈ q * s."""
    w = w.to(torch.float32)
    dims = tuple(d for d in range(w.dim()) if d != axis % w.dim())
    absmax = torch.amax(w.abs(), dim=dims, keepdim=True)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {'q': q, 's': s}


def _is_qleaf(x):
    return isinstance(x, dict) and set(x) == {'q', 's'}


def _tensor(name, v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v))
    raise TypeError(f'{name}: a {type(v).__name__}, not a tensor or an '
                    f'array (the trees here are flat name -> tensor maps)')


def quantize_tree(params):
    """``{name: tensor}`` -> the same names with every kernel as ``{'q':
    int8, 's': f32}`` on its device; the other tensors are copied, so the
    result holds no reference to ``params``."""
    out = {}
    for name, v in params.items():
        t = _tensor(name, v)
        if _is_quantizable(name, t):
            out[name] = _quantize_leaf(t, 0 if _is_conv(name) else -1)
        else:
            out[name] = t.clone()
    return out


def dequantize_tree(qtree, dtype=torch.float32):
    """Inverse of :func:`quantize_tree` (lossy): ``q * s`` in f32, then
    ``dtype``; the other tensors pass through."""
    return {name: ((v['q'] * v['s']).to(dtype) if _is_qleaf(v) else v)
            for name, v in qtree.items()}


def quantized_apply(model, qtree, *args, **kwargs):
    """``model(*args, **kwargs)`` with its parameters dequantized from
    ``qtree`` (the model's buffers, such as the frozen data-norm stats, are
    its own)."""
    tensors = dict(model.named_buffers())
    tensors.update(dequantize_tree(qtree))
    return functional_call(model, tensors, args, kwargs)


def _flax_key(name):
    """``(the JAX package's '/'-joined key, whether the layout flips)``."""
    if _is_conv(name):
        return name[:-len('weight')].replace('.', '/') + 'kernel', True
    return name.replace('.', '/'), False


def _port_name(key):
    name = key.replace('/', '.')
    conv, leaf = is_conv_param(name)
    if conv and leaf == 'kernel':
        return name[:-len('kernel')] + 'weight', True
    return name, False


def _wio(a, flip):
    """The WIO / ``[cout, cin, K]`` swap (its own inverse)."""
    return np.ascontiguousarray(a.transpose(2, 1, 0)) if flip else a


def save_quantized(path, qtree):
    """Write a quantized tree to one ``.npz`` with the JAX package's keys:
    ``'/'``-joined flax paths, ``#q``/``#s`` on the quantized kernels'
    halves, an ``nn.Conv`` kernel (and its scales) in flax's WIO layout."""
    flat = {}
    for name, v in qtree.items():
        key, flip = _flax_key(name)
        if _is_qleaf(v):
            flat[key + '#q'] = _wio(v['q'].cpu().numpy(), flip)
            flat[key + '#s'] = _wio(v['s'].cpu().numpy(), flip)
        else:
            flat[key] = _wio(v.detach().cpu().numpy(), flip)
    np.savez(path, **flat)


def load_quantized(path):
    """Inverse of :func:`save_quantized` (CPU tensors); reads the JAX
    package's files too."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            base, _, half = key.partition('#')
            name, flip = _port_name(base)
            t = torch.from_numpy(_wio(z[key], flip))
            if half:
                out.setdefault(name, {})[half] = t
            else:
                out[name] = t
    return out


def quantized_size_bytes(qtree):
    """``(quantized_bytes, f32_bytes)`` of a quantized tree, counted as the
    JAX package counts them: a kernel's int8 and f32 scales against its f32
    size, every other tensor at its own size against f32."""
    qb = fb = 0
    for v in qtree.values():
        if _is_qleaf(v):
            qb += v['q'].numel() + v['s'].numel() * 4
            fb += v['q'].numel() * 4
        else:
            qb += v.numel() * v.element_size()
            fb += v.numel() * 4
    return qb, fb
