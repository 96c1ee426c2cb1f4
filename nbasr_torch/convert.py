"""Weights between the JAX package's variable trees and the port's state dicts.

A flax tree ``{'params': {...}, 'stats': {...}}`` of arrays maps to a flat
state dict whose keys are the flax paths joined with ``'.'`` — the port's
modules carry the JAX package's module and parameter names — with one
layout change: an ``nn.Conv``'s ``.../conv/kernel`` ``[K, cin, cout]``
(WIO; ``cin`` per group) becomes ``.../conv.weight`` ``[cout, cin, K]``
(``bias`` likewise becomes ``.conv.bias``).  Those are the dense block
convs (``block{i}_conv/conv``) and a cell's conv nodes where the JAX
package runs ``nn.Conv``: ``grouped_impl='native'``, and every unfused
path at ``cell_groups=1`` (``node{n}_conv5/conv`` ...).  Everything else
keeps its layout: compact grouped kernels ``[K, ci, C]``, dense kernels
``[in, out]``, the LSTM's Keras layout (gate order i, f, g, o).  The
``stats`` collection (``data_norm/mean``, ``data_norm/variance``) becomes
the MVN buffers.  Adam's moments (optax ``mu``/``nu``, trees shaped like
``params``) map the same way (:func:`adam_from_flax`,
:func:`adam_to_flax`).  Both directions are exact copies.
"""

import numpy as np
import torch

__all__ = ['from_flax', 'to_flax', 'adam_from_flax', 'adam_to_flax',
           'is_conv_param', 'flax_key']

_STATS = ('data_norm.mean', 'data_norm.variance')


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if hasattr(v, 'items'):
            yield from _flatten(v, key + '.')
        else:
            yield key, np.asarray(v)


def is_conv_param(key):
    """(whether ``key`` is a parameter of an ``nn.Conv`` — a block conv, or
    a cell's conv node on the ``'native'`` or a ``cell_groups=1`` unfused
    path — and its leaf name)."""
    head, _, leaf = key.rpartition('.')
    return head == 'conv' or head.endswith('.conv'), leaf


def flax_key(key):
    """``(flax path joined with '.', transposed)`` of a state-dict key:
    an ``nn.Conv``'s ``weight`` is flax's ``kernel`` with its axes
    reversed (``[cout, cin, K]`` against ``[K, cin, cout]``), every other
    key keeps its name and layout."""
    conv, leaf = is_conv_param(key)
    if conv and leaf == 'weight':
        return key[:-len('weight')] + 'kernel', True
    return key, False


def from_flax(variables):
    """``{'params': ..., 'stats': ...}`` of arrays -> torch state dict."""
    state = {}
    for collection in ('params', 'stats'):
        for key, arr in _flatten(variables.get(collection, {})):
            block_conv, leaf = is_conv_param(key)
            if block_conv and leaf == 'kernel':
                key = key[:-len('kernel')] + 'weight'
                arr = arr.transpose(2, 1, 0)
            state[key] = torch.tensor(arr)
    return state


def to_flax(state_dict):
    """Torch state dict -> ``{'params': ..., 'stats': ...}`` of numpy arrays
    (``'stats'`` only when the model has a data norm)."""
    out = {'params': {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        block_conv, leaf = is_conv_param(key)
        if block_conv and leaf == 'weight':
            key = key[:-len('weight')] + 'kernel'
            arr = arr.transpose(2, 1, 0)
        node = out.setdefault('stats', {}) if key in _STATS else out['params']
        *path, leaf = key.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def adam_from_flax(adam):
    """An optax ``scale_by_adam`` state ``{'count', 'mu', 'nu'}`` ->
    ``(count, {name: exp_avg}, {name: exp_avg_sq})`` in the state dict's
    names and layouts."""
    return (int(np.asarray(adam['count'])),
            from_flax({'params': adam['mu']}),
            from_flax({'params': adam['nu']}))


def adam_to_flax(count, exp_avg, exp_avg_sq):
    """Inverse of :func:`adam_from_flax`: ``count`` int32, the moments as
    trees shaped like flax's ``params``."""
    return {'count': np.asarray(count, np.int32),
            'mu': to_flax(exp_avg)['params'],
            'nu': to_flax(exp_avg_sq)['params']}
