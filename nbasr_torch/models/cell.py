"""Search cell: a small DAG of ops + identity skip branches, in one kernel.

Counterpart of ``nbasr_tpu/models/cell.py`` ``SearchCell`` on its fused
path (``_fused``): node *i* computes ``op_i(prev)``, clip-ReLU(20) and
dropout, and adds ``inputs[j]`` for every live branch bit, then a
LayerNorm.  The whole cell is one call of
:func:`nbasr_torch.ops.fused_cell.fused_cell_forward` — the CUDA kernels on
the card, their plain versions on the CPU — forward and backward.
Parameter names match the JAX cell's (``node{n}_{op}/conv_kernel_grouped``
..., ``norm/scale``).

Like the JAX cell's ``train=False`` default, a cell is built in eval mode;
``.train()`` turns its dropout on, and each training call then draws the
cell's dropout seed from the ``torch.Generator`` its caller passes.
"""

import torch
from torch import nn

from ..ops.fused_cell import (ConvNode, FusedCellSpec, LinearNode, ZeroNode,
                              fused_cell_forward)
from .layers import LayerNorm, LinearRelu, conv_padding, kernel_initializer, \
    norm_eps

__all__ = ['SearchCell', 'CELL_DROPOUT']

#: Cell-op dropout is a constant 0.2 in the reference (tf/ops.py:60), not
#: the model-level dropout flag (which only feeds the LSTM).
CELL_DROPOUT = 0.2

_CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2),
          'conv7': (7, 1), 'conv7d2': (7, 2)}

#: ``grouped_impl`` values of the JAX package whose kernels or lowerings
#: later slices of the port bring.
_LATER_IMPLS = ('pallas', 'pallas_split', 'chunked', 'masked_dense', 'native')


class _ConvParams(nn.Module):
    """A conv node's compact grouped kernel ``[K, ci, C]`` and its bias."""

    def __init__(self, kernel_size, cin, filters, init_scheme, generator):
        super().__init__()
        self.conv_kernel_grouped = nn.Parameter(kernel_initializer(
            init_scheme)((kernel_size, cin, filters), generator))
        self.conv_bias = nn.Parameter(torch.zeros(filters))


class SearchCell(nn.Module):
    """Nodes over a growing list of outputs, then LayerNorm.

    ``arch_desc`` is the named form ``[[op_name, b...], ...]``.
    ``grouped_impl`` ``'auto'`` and ``'fused'`` both run the fused cell;
    the JAX package's other implementations raise NotImplementedError.
    """

    def __init__(self, filters, arch_desc, dropout_rate=CELL_DROPOUT,
                 use_norm=True, groups=100,
                 init_scheme='reference', grouped_impl='auto',
                 branch_semantics='canonical', apply_dilation=True,
                 pad_math='torch', norm_epsilon=norm_eps, generator=None):
        super().__init__()
        if grouped_impl in _LATER_IMPLS:
            raise NotImplementedError(
                f"grouped_impl={grouped_impl!r} is not ported yet (see "
                f"ROADMAP.md, queue 2); 'auto' and 'fused' run the fused cell")
        if grouped_impl not in ('auto', 'fused'):
            raise ValueError(f'unknown grouped_impl: {grouped_impl!r}')
        if branch_semantics not in ('canonical', 'tf_inverted'):
            raise ValueError(f'unknown branch_semantics: {branch_semantics!r}')
        if groups < 1 or filters % groups:
            raise ValueError(f'filters={filters} is not a multiple of '
                             f'groups={groups}')
        generator = generator or torch.Generator().manual_seed(0)
        C = filters
        ci = C // groups
        live = 0 if branch_semantics == 'tf_inverted' else 1
        nodes = []
        self._param_nodes = []
        for nidx, (op_name, *bits) in enumerate(arch_desc):
            branches = tuple(j for j, b in enumerate(bits) if b == live)
            name = f'node{nidx}_{op_name}'
            if op_name == 'zero':
                nodes.append(ZeroNode(branches))
                continue
            if op_name == 'linear':
                self.add_module(name, LinearRelu(C, C, init_scheme, generator))
                nodes.append(LinearNode(branches))
            elif op_name in _CONVS:
                K, d = _CONVS[op_name]
                if not apply_dilation:
                    d = 1
                lpad, rpad = conv_padding(K, d, 1, pad_math=pad_math)
                self.add_module(name, _ConvParams(K, ci, C, init_scheme,
                                                  generator))
                nodes.append(ConvNode(K, d, lpad, rpad, groups, ci, ci,
                                      branches))
            else:
                raise ValueError(f'Unknown op: {op_name!r}')
            self._param_nodes.append(name)
        self.norm = LayerNorm(C, norm_epsilon) if use_norm else None
        self.spec = FusedCellSpec(nodes, ln_eps=norm_epsilon,
                                  use_norm=use_norm)
        self.train_spec = FusedCellSpec(nodes, dropout_rate=dropout_rate,
                                        train=True, ln_eps=norm_epsilon,
                                        use_norm=use_norm)
        self.eval()

    def operands(self, dtype):
        """``(weights, ln)`` as :func:`fused_cell_forward` takes them for
        activations of ``dtype``: kernels cast to it, biases f32."""
        weights = []
        for name in self._param_nodes:
            p = getattr(self, name)
            if isinstance(p, LinearRelu):
                w, b = p.dense.kernel, p.dense.bias
            else:
                w, b = p.conv_kernel_grouped, p.conv_bias
            weights += [w.to(dtype), b]
        ln = (self.norm.scale, self.norm.bias) if self.norm is not None else None
        return weights, ln

    def forward(self, x, generator=None):
        """``[B, T, C] -> [B, T, C]``; ``generator`` supplies the dropout
        seed in training mode."""
        spec = self.train_spec if self.training else self.spec
        seed = _draw_seed(generator, x.device) if spec.dropping else None
        return fused_cell_forward(spec, x.contiguous(),
                                  *self.operands(x.dtype), seed=seed)


def _draw_seed(generator, device):
    """A dropout seed as the JAX cell draws one (``cell.py:312-316``): two
    int32 in ``[0, 2**31 - 1)``, here from an explicit CPU generator, then
    moved to ``device`` without waiting for it."""
    if generator is None:
        raise ValueError('dropout in training mode draws from a '
                         'torch.Generator: pass generator=, or call .eval()')
    seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                         dtype=torch.int32)
    if device.type == 'cuda':
        return seed.pin_memory().to(device, non_blocking=True)
    return seed.to(device)
