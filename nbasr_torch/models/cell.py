"""Search cell: a small DAG of ops + identity skip branches.

Counterpart of ``nbasr_tpu/models/cell.py`` ``SearchCell``: node *i*
computes ``op_i(prev)``, clip-ReLU(20) and dropout, and adds ``inputs[j]``
for every live branch bit, then a LayerNorm.  On the fused path
(``grouped_impl`` ``'auto'``, ``'fused'``, ``'fused_aligned'``) the whole
cell is one call of :func:`nbasr_torch.ops.fused_cell.fused_cell_forward`
— the CUDA kernels on the card, their plain versions on the CPU — forward
and backward.  On the unfused paths (the JAX cell's ``__call__`` loop)
each op runs itself: every conv node is the grouped conv kernel
(``nbasr_torch/ops/grouped_conv.py``) on ``'pallas'`` and
``'pallas_split'``, and the JAX package's XLA lowering in stock PyTorch on
``'chunked'``, ``'masked_dense'`` and ``'native'``; the rest are plain
torch ops.  Parameter names match the JAX cell's
(``node{n}_{op}/conv_kernel_grouped`` ..., ``norm/scale``; ``nn.Conv``'s
``node{n}_{op}/conv/kernel`` on ``'native'`` and on every unfused path at
``groups=1``) on every path.

Like the JAX cell's ``train=False`` default, a cell is built in eval mode;
``.train()`` turns its dropout on, and each training call then draws the
cell's dropout seed from the ``torch.Generator`` its caller passes.  Every
path takes its masks from that seed through the same stateless hash, so
the three compute the same training function up to rounding (and the
split path's gate at exact ties).
"""

import torch
from torch import nn

from ..ops.fused_cell import (ConvNode, FusedCellSpec, LinearNode, ZeroNode,
                              fused_cell_forward)
from ..ops.grouped_conv import from_split, to_split
from ..utils import tracing
from .layers import CELL_CONV_IMPLS, GroupedPadConvRelu, LayerNorm, \
    LinearRelu, SplitLayerNorm, conv_padding, norm_eps

__all__ = ['SearchCell', 'CELL_DROPOUT']

#: Cell-op dropout is a constant 0.2 in the reference (tf/ops.py:60), not
#: the model-level dropout flag (which only feeds the LSTM).
CELL_DROPOUT = 0.2

_CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2),
          'conv7': (7, 1), 'conv7d2': (7, 2)}

#: ``grouped_impl`` values that run the fused cell.  ``'fused_aligned'``
#: is the JAX kernel in a 128-lane padded layout, a TPU layout the port does
#: not carry: here it is the fused cell.
_FUSED_IMPLS = ('auto', 'fused', 'fused_aligned')


class SearchCell(nn.Module):
    """Nodes over a growing list of outputs, then LayerNorm.

    ``arch_desc`` is the named form ``[[op_name, b...], ...]``.
    ``grouped_impl`` ``'auto'``, ``'fused'`` and ``'fused_aligned'`` run the
    fused cell; ``'pallas'``, ``'chunked'``, ``'masked_dense'`` and
    ``'native'`` run the ops on ``[B, T, C]``, and ``'pallas_split'`` (at
    ``groups > 1``, as in the JAX cell) on the split layout ``[B, C //
    groups, T, groups]`` (input and output too: :class:`ASRModel` converts
    once per block).  A training call takes its dropout seed from
    ``generator``, or ``seed`` drawn beforehand with :meth:`draw_seed` (so
    a recomputation draws none).
    """

    def __init__(self, filters, arch_desc, dropout_rate=CELL_DROPOUT,
                 use_norm=True, groups=100,
                 init_scheme='reference', grouped_impl='auto',
                 branch_semantics='canonical', apply_dilation=True,
                 pad_math='torch', norm_epsilon=norm_eps, generator=None):
        super().__init__()
        if grouped_impl not in _FUSED_IMPLS + CELL_CONV_IMPLS:
            raise ValueError(f'unknown grouped_impl: {grouped_impl!r}')
        if branch_semantics not in ('canonical', 'tf_inverted'):
            raise ValueError(f'unknown branch_semantics: {branch_semantics!r}')
        if groups < 1 or filters % groups:
            raise ValueError(f'filters={filters} is not a multiple of '
                             f'groups={groups}')
        generator = generator or torch.Generator().manual_seed(0)
        C = filters
        ci = C // groups
        self.fused = grouped_impl in _FUSED_IMPLS
        self.split = grouped_impl == 'pallas_split' and groups > 1
        self.groups = groups
        self.dropout_rate = dropout_rate
        live = 0 if branch_semantics == 'tf_inverted' else 1
        nodes = []
        self._op_names = []      # per node: its module's name, None if zero
        for nidx, (op_name, *bits) in enumerate(arch_desc):
            branches = tuple(j for j, b in enumerate(bits) if b == live)
            name = f'node{nidx}_{op_name}'
            if op_name == 'zero':
                nodes.append(ZeroNode(branches))
                self._op_names.append(None)
                continue
            self._op_names.append(name)
            if op_name == 'linear':
                self.add_module(name, LinearRelu(C, C, init_scheme, generator,
                                                 dropout_rate))
                nodes.append(LinearNode(branches))
            elif op_name in _CONVS:
                K, d = _CONVS[op_name]
                if not apply_dilation:
                    d = 1
                lpad, rpad = conv_padding(K, d, 1, pad_math=pad_math)
                self.add_module(name, GroupedPadConvRelu(
                    ci, C, K, d, groups, dropout_rate,
                    'fused' if self.fused else grouped_impl, pad_math,
                    init_scheme, generator))
                nodes.append(ConvNode(K, d, lpad, rpad, groups, ci, ci,
                                      branches))
            else:
                raise ValueError(f'Unknown op: {op_name!r}')
        norm = SplitLayerNorm if self.split else LayerNorm
        self.norm = norm(C, norm_epsilon) if use_norm else None
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
        for name in filter(None, self._op_names):
            p = getattr(self, name)
            if isinstance(p, LinearRelu):
                w, b = p.dense.kernel, p.dense.bias
            else:
                w, b = p.conv_kernel_grouped, p.conv_bias
            weights += [w.to(dtype), b]
        ln = (self.norm.scale, self.norm.bias) if self.spec.use_norm else None
        return weights, ln

    @property
    def dropping(self):
        """Whether a call in the current mode draws a dropout seed."""
        return self.training and self.dropout_rate > 0

    def draw_seed(self, generator, device):
        """The seed a call on ``device`` draws from ``generator``, or None
        when it drops nothing.  The fused kernel reads it on the card; the
        unfused ops hash their masks from a seed kept on the CPU, so that
        reading it does not wait for the card."""
        if not self.dropping:
            return None
        return _draw_seed(generator, device if self.fused
                          else torch.device('cpu'))

    @tracing.module_span('cell')
    def forward(self, x, generator=None, seed=None):
        """``[B, T, C] -> [B, T, C]`` (split: ``[B, c, T, G]`` both ways);
        in training mode the dropout seed is ``seed`` if given (from
        :meth:`draw_seed`), else drawn from ``generator``."""
        if seed is None:
            seed = self.draw_seed(generator, x.device)
        if self.fused:
            spec = self.train_spec if self.training else self.spec
            y = fused_cell_forward(spec, x.contiguous(),
                                   *self.operands(x.dtype), seed=seed)
            # a norm outside the kernel: a tensor-parallel shard's
            # (nbasr_torch.parallel.tensor.DistributedLayerNorm)
            return y if spec.use_norm or self.norm is None else self.norm(y)
        outputs = [x]
        counter = 0
        for name, node in zip(self._op_names, self.spec.nodes):
            total = None
            if name is not None:
                op = getattr(self, name)
                counter += 1
                if self.split and node.kind == 'linear':
                    # the full-channel matmul round-trips to dense
                    total = to_split(op(from_split(outputs[-1]), seed, counter),
                                     self.groups)
                else:
                    total = op(outputs[-1], seed, counter)
            for j in node.branches:
                total = outputs[j] if total is None else total + outputs[j]
            if total is None:                    # zero op, no live branch
                total = outputs[-1] * 0.0
            outputs.append(total)
        out = outputs[-1]
        return out if self.norm is None else self.norm(out)


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
