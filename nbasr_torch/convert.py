"""Weights between the JAX package's variable trees and the port's state dicts.

A flax tree ``{'params': {...}, 'stats': {...}}`` of arrays maps to a flat
state dict whose keys are the flax paths joined with ``'.'`` — the port's
modules carry the JAX package's module and parameter names — with one
layout change: a dense block conv's ``block{i}_conv/conv/kernel`` ``[K, cin,
cout]`` (WIO) becomes ``block{i}_conv.conv.weight`` ``[cout, cin, K]``
(``bias`` likewise becomes ``.conv.bias``).  Everything else keeps its
layout: compact grouped kernels ``[K, ci, C]``, dense kernels ``[in, out]``,
the LSTM's Keras layout (gate order i, f, g, o).  The ``stats`` collection
(``data_norm/mean``, ``data_norm/variance``) becomes the MVN buffers.
Both directions are exact copies.
"""

import numpy as np
import torch

__all__ = ['from_flax', 'to_flax']

_STATS = ('data_norm.mean', 'data_norm.variance')


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if hasattr(v, 'items'):
            yield from _flatten(v, key + '.')
        else:
            yield key, np.asarray(v)


def _is_block_conv(key):
    """(whether ``key`` is a parameter of a dense block conv, its leaf name)."""
    head, _, leaf = key.rpartition('.')
    return head.endswith('_conv.conv'), leaf


def from_flax(variables):
    """``{'params': ..., 'stats': ...}`` of arrays -> torch state dict."""
    state = {}
    for collection in ('params', 'stats'):
        for key, arr in _flatten(variables.get(collection, {})):
            block_conv, leaf = _is_block_conv(key)
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
        block_conv, leaf = _is_block_conv(key)
        if block_conv and leaf == 'weight':
            key = key[:-len('weight')] + 'kernel'
            arr = arr.transpose(2, 1, 0)
        node = out.setdefault('stats', {}) if key in _STATS else out['params']
        *path, leaf = key.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
