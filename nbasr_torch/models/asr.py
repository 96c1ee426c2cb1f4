"""The flagship ASR encoder: arch_vec -> CTC-ready logits, PyTorch.

Counterpart of ``nbasr_tpu/models/asr.py``:

  [B, T, 80] log-mel → mask → frozen mean/var norm →
  4 × (PadConvRelu(k=8, stride 1/1/2/2, filters 600/800/1000/1200)
       → LayerNorm → {3,4,5,6} SearchCells)
  → optional LSTM(500) → Dense(49)

Forward and backward: every SearchCell runs the fused cell kernels
(``grouped_impl`` ``'auto'``), or each of its conv nodes the grouped conv
kernels (``'pallas'``; ``'pallas_split'`` with each block's cell stack in
the split layout ``[B, C // G, T, G]``) or the JAX package's XLA lowerings
in stock PyTorch (``'chunked'``, ``'masked_dense'``, ``'native'``), with
the cells' dropout (``cell_dropout``, 0.2) and the pre-LSTM dropout
(``dropout_rate``) in training mode.  ``block_conv_impl='tap_matmul'``
runs the block convs as shifted matmuls; ``remat_cells=True`` recomputes
each cell's forward in the backward (``torch.utils.checkpoint``) instead
of keeping what it saves.  Like the JAX model's ``train=False``
default, a model is built in eval mode; ``.train()`` turns dropout on, and
a training call then draws every dropout decision from the
``torch.Generator`` it is given.  Parameter counts for the README arch
``[[1,0],[1,0,0],[1,0,0,0]]``: 26,339,349 with the LSTM head and
22,971,649 without, as the JAX model.
"""

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.grouped_conv import from_split, to_split
from ..search_space import arch_vec_to_names
from .cell import CELL_DROPOUT, SearchCell
from .layers import Dense, LayerNorm, MeanVarianceNorm, PadConvRelu, \
    kernel_initializer, norm_eps
from .lstm import FastLSTM

__all__ = ['ASRModel', 'get_model', 'count_params', 'logits_length',
           'resolve_device', 'algorithmic_flops']

_BLOCK_KERNELS = (8, 8, 8, 8)
_BLOCK_STRIDES = (1, 1, 2, 2)
_BLOCK_FILTERS = (600, 800, 1000, 1200)
_CELLS_PER_BLOCK = (3, 4, 5, 6)
_NUM_FEATURES = 80


def resolve_device(device):
    """``torch.device(device)`` with a CUDA device's index filled in,
    refusing a CUDA device the machine lacks (the port's entry points
    default to the card and never fall back)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port's plain "
                               "versions on the CPU")
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device


class ASRModel(nn.Module):
    """NAS-Bench-ASR encoder for a fixed cell architecture.

    ``arch_desc`` uses op *names* (``[['conv5', 0], ...]``); build from an
    index vector with :func:`get_model` / :meth:`from_arch_vec`.  The
    keyword arguments are the JAX model's fields; the module is built on
    the CPU from ``generator`` (seed 0 when none is given).
    """

    def __init__(self, arch_desc, num_classes=48, use_rnn=False, use_norm=True,
                 dropout_rate=0.0, cell_dropout=CELL_DROPOUT,
                 data_mean=None, data_variance=None,
                 compute_dtype=torch.float32, block_kernels=_BLOCK_KERNELS,
                 block_strides=_BLOCK_STRIDES, block_filters=_BLOCK_FILTERS,
                 cells_per_block=_CELLS_PER_BLOCK, cell_groups=100,
                 rnn_units=500, init_scheme='scaled', grouped_impl='auto',
                 block_conv_impl='auto', remat_cells=False,
                 branch_semantics='canonical', apply_dilation=True,
                 pad_math='torch', norm_epsilon=norm_eps, generator=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.arch_desc = tuple(tuple(n) for n in arch_desc)
        self.use_rnn = use_rnn
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.block_kernels = tuple(block_kernels)
        self.block_strides = tuple(block_strides)
        self.block_filters = tuple(block_filters)
        self.cells_per_block = tuple(cells_per_block)
        self.cell_groups = cell_groups
        self.grouped_impl = grouped_impl
        #: whether each block's cell stack runs in the split layout
        #: ('pallas_split'); a tensor-parallel shard that holds no whole
        #: groups keeps its blocks dense (parallel.tensor)
        self.split_blocks = grouped_impl == 'pallas_split' and cell_groups > 1
        self.remat_cells = remat_cells
        self.num_classes = num_classes
        self.rnn_units = rnn_units
        self.data_norm = (None if data_mean is None else MeanVarianceNorm(
            np.asarray(data_mean, np.float32),
            np.asarray(data_variance, np.float32), epsilon=norm_epsilon))
        cin = _NUM_FEATURES
        for i, (kernel, stride, filters, cells) in enumerate(zip(
                block_kernels, block_strides, block_filters, cells_per_block)):
            self.add_module(f'block{i}_conv', PadConvRelu(
                cin, filters, kernel, strides=stride, pad_math=pad_math,
                init_scheme=init_scheme, generator=generator,
                impl=block_conv_impl))
            self.add_module(f'block{i}_norm', LayerNorm(filters, norm_epsilon))
            for j in range(cells):
                self.add_module(f'block{i}_cell{j}', SearchCell(
                    filters, self.arch_desc, dropout_rate=cell_dropout,
                    use_norm=use_norm,
                    groups=cell_groups, init_scheme=init_scheme,
                    grouped_impl=grouped_impl,
                    branch_semantics=branch_semantics,
                    apply_dilation=apply_dilation, pad_math=pad_math,
                    norm_epsilon=norm_epsilon, generator=generator))
            cin = filters
        if use_rnn:
            self.lstm = FastLSTM(cin, rnn_units, compute_dtype=compute_dtype,
                                 generator=generator)
            cin = rnn_units
        self.head = Dense(cin, num_classes + 1, kernel_initializer('reference'),
                          generator)
        self.eval()

    @classmethod
    def from_arch_vec(cls, arch_vec, **kwargs):
        return cls(arch_vec_to_names(arch_vec), **kwargs)

    def forward(self, features, feature_size=None, mask=None, stage='full',
                rnn_carry=None, return_rnn_carry=False, generator=None):
        """[B, T, 80] features (+ true frame counts) -> [B, ceil(T/4), C+1]
        f32 logits.  ``stage='encode'`` returns the conv-block output;
        ``'head'`` takes that output and runs LSTM + Dense, threading the
        LSTM ``(c, h)`` carry through ``rnn_carry``/``return_rnn_carry``.
        In training mode ``generator`` (a CPU ``torch.Generator``) supplies
        the cells' dropout seeds and the pre-LSTM dropout mask; with
        ``remat_cells`` each cell's seed is drawn before its checkpointed
        call, so the recomputation uses the same masks and draws none."""
        if stage not in ('full', 'encode', 'head'):
            raise ValueError(f'unknown stage: {stage!r}')
        x = features
        if stage != 'head':
            x = features.to(self.compute_dtype)
            if mask is None and feature_size is not None:
                t = torch.arange(x.shape[1], device=x.device)[None, :]
                mask = t < feature_size[:, None]
            if mask is not None:
                x = torch.where(mask[..., None], x,
                                torch.zeros((), dtype=x.dtype, device=x.device))
            if self.data_norm is not None:
                x = self.data_norm(x, mask=mask)
            # 'pallas_split' keeps each block's cell stack in the split
            # layout: one conversion each way per block, in the groups the
            # block's channels hold (a tensor-parallel shard's G / tp)
            for i, cells in enumerate(self.cells_per_block):
                x = getattr(self, f'block{i}_conv')(x)
                x = getattr(self, f'block{i}_norm')(x)
                if self.split_blocks:
                    per_group = self.block_filters[i] // self.cell_groups
                    x = to_split(x, x.shape[-1] // per_group)
                for j in range(cells):
                    cell = getattr(self, f'block{i}_cell{j}')
                    if self.remat_cells and torch.is_grad_enabled():
                        seed = cell.draw_seed(generator, x.device)
                        x = checkpoint(cell, x, None, seed,
                                       use_reentrant=False)
                    else:
                        x = cell(x, generator)
                if self.split_blocks:
                    x = from_split(x)
            if stage == 'encode':
                return x
        carry = None
        if self.use_rnn:
            if self.training and self.dropout_rate:
                x = _time_shared_dropout(x, self.dropout_rate, generator)
            x, carry = self.lstm(x, initial_carry=rnn_carry, return_carry=True)
        x = self.head(x.float())
        return (x, carry) if return_rnn_carry else x


def _time_shared_dropout(x, rate, generator):
    """Dropout of ``[B, T, F]`` with one mask per (b, f) shared across time,
    as the JAX model's pre-LSTM ``nn.Dropout(broadcast_dims=(1,))`` (Keras
    LSTM(dropout=r), ``model/tf/model.py:87-88``); the mask is drawn on the
    CPU from ``generator``."""
    if generator is None:
        raise ValueError('dropout in training mode draws from a '
                         'torch.Generator: pass generator=, or call .eval()')
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0], 1, x.shape[2]), generator=generator) < keep
    if x.device.type == 'cuda':
        mask = mask.pin_memory().to(x.device, non_blocking=True)
    return torch.where(mask.to(x.device), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def logits_length(feature_size, t_in, t_out):
    """True output lengths from true input lengths via the float32 ratio
    ``t_in / t_out`` (TF's ``get_logits_size``), as an int32 tensor."""
    ratio = (torch.tensor(t_in, dtype=torch.float32)
             / torch.tensor(t_out, dtype=torch.float32))
    return (torch.as_tensor(feature_size).to(torch.float32) / ratio).to(
        torch.int32)


def get_model(arch_vec, use_rnn=True, dropout_rate=0.0, use_norm=True,
              data_norm=None, num_classes=48, compute_dtype=torch.float32,
              device='cuda', generator=None, **overrides):
    """Model factory (reference ``model/__init__.py:19-20``) on ``device``.

    ``data_norm`` may be ``True`` (the frozen TIMIT train stats), a
    ``(mean, variance)`` pair, or ``None``.  Extra keyword arguments
    override :class:`ASRModel` fields.
    """
    device = resolve_device(device)
    if data_norm is True:
        from ..data import load_train_stats
        data_norm = load_train_stats()
    mean, var = (None, None) if data_norm is None else data_norm
    model = ASRModel.from_arch_vec(
        arch_vec, num_classes=num_classes, use_rnn=use_rnn, use_norm=use_norm,
        dropout_rate=dropout_rate, data_mean=mean, data_variance=var,
        compute_dtype=compute_dtype, generator=generator, **overrides)
    return model.to(device)


def count_params(model):
    """Total number of parameter elements (the frozen stats not counted)."""
    return sum(p.numel() for p in model.parameters())


def algorithmic_flops(model, batch, frames, train=True):
    """Algorithmic matmul FLOPs of one step, as the JAX package counts them
    (``nbasr_tpu/models/asr.py:230-264``): 2 per multiply-add of the block
    convs, the cell ops (true grouped cost ``2*B*T*K*G*ci*co``), the LSTM
    and the head; elementwise work excluded; ``train=True`` multiplies by 3
    (backward about twice the forward)."""
    B, T = batch, frames
    fwd = 0.0
    t = T
    cin = _NUM_FEATURES
    for k, s, c, cells in zip(model.block_kernels, model.block_strides,
                              model.block_filters, model.cells_per_block):
        t = -(-t // s)
        fwd += 2.0 * B * t * k * cin * c
        ci = c // model.cell_groups
        per_conv = 2.0 * B * t * model.cell_groups * ci * ci
        for op_name, *_ in model.arch_desc:
            if op_name == 'linear':
                fwd += cells * 2.0 * B * t * c * c
            elif op_name.startswith('conv'):
                fwd += cells * per_conv * int(op_name[4])
        cin = c
    if model.use_rnn:
        h = model.rnn_units
        fwd += 2.0 * B * t * 4 * h * (cin + h)
        cin = h
    fwd += 2.0 * B * t * cin * (model.num_classes + 1)
    return fwd * (3.0 if train else 1.0)
