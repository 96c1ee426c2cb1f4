"""Tensor parallelism of the port over a mesh's ``'model'`` dim.

The JAX package places the parameters by ``param_spec`` and lets GSPMD
partition the ``'chunked'`` lowering (``nbasr_tpu/parallel/
train_parallel.py:31-59``).  The port runs one process per device, so the
collectives are explicit here, as autograd Functions over the ``'model'``
group, and the cells keep their fused kernels.

:func:`tensor_parallel` swaps the model's modules in place, every
parameter keeping its name; each rank holds plain local tensors, its slice
of every parameter :func:`~nbasr_torch.parallel.mesh.param_spec` shards
and the whole of the others.  The activations between blocks and cells are
sharded on channels, ``C / tp`` a rank (``c0 = rank * C / tp`` its first):

- a block conv is column-parallel: its input channel-gathered (blocks
  1-3; block 0 reads the replicated features), its output this rank's
  channels, with its slice of the replicated bias (and of the weight where
  ``param_spec`` replicates it); its LayerNorm a
  :class:`DistributedLayerNorm`;
- a cell whose nodes are conv or zero, whose groups ``tp`` divides and
  whose kernels ``param_spec`` shards runs **channel-parallel**: the same
  cell on ``C / tp`` channels in ``G / tp`` groups (its groups lie whole on
  one rank, so the nodes need no communication), without LayerNorm (in the
  fused kernel with the dropout hash's channel offset ``c0``: its masks
  are the whole cell's), then a :class:`DistributedLayerNorm`;
- any other cell (a ``linear`` node, groups ``tp`` does not divide,
  replicated kernels) runs **whole** on every model rank, its input
  gathered and its sharded weights gathered, and keeps its shard of the
  output;
- after the last cell the encoder output is gathered, and the pre-LSTM
  dropout, the LSTM and the head run replicated with gathered weights.

Gradients: what every model rank computes alike (a whole cell, the head)
gets the same gradient on every rank, so gathering a tensor for it
(:func:`replicate_channels`, :func:`gather_param`) takes this rank's slice
back, and taking a shard of its output (:func:`shard_channels`) gathers
the gradient.  A column-parallel conv's gradient to its gathered input is
partial on each rank, so :func:`gather_channels` reduce-scatters it.  A
replicated parameter that the compute uses sliced (LayerNorm scale and
bias, a block conv's bias) gets only its slice's gradient on each rank:
:func:`sum_sliced_grads` sums those over ``'model'`` after the backward.
``model.tp_layout`` records, per parameter name, ``('shard', dim)``,
``('slice', dim)`` or ``('whole', None)``.

The collectives follow the group's backend: NCCL takes CUDA tensors
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``);
gloo gets host tensors (a CUDA tensor is copied to the host and back,
each copy counted in :data:`STAGED`) and runs ``all_gather`` and
``all_reduce``, the reduce-scatter as an all-reduce and a slice.  Nothing
falls back: a collective that fails raises.
"""

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..models.layers import GroupedPadConvRelu
from ..ops.fused_cell import ConvNode, FusedCellSpec, ZeroNode
from ..training.loss import L2_COEFF, _is_conv_kernel
from .mesh import TP_LATER, param_shardings

__all__ = ['ModelGroup', 'tensor_parallel', 'gather_channels',
           'replicate_channels', 'shard_channels', 'gather_param',
           'all_reduce_sum', 'DistributedLayerNorm', 'sum_sliced_grads',
           'conv_l2', 'grad_norm_sq', 'all_reduce_max', 'gather_named',
           'shard_named', 'STAGED', 'reset_staged']

#: Host copies of CUDA tensors for gloo collectives since the last
#: :func:`reset_staged` (each way counted), and their bytes.
STAGED = {'copies': 0, 'bytes': 0}


def reset_staged():
    STAGED.update(copies=0, bytes=0)


class ModelGroup:
    """The ``'model'`` group of a mesh as this rank sees it: the process
    group, this rank's index in it and its size."""

    def __init__(self, group, rank, size):
        self.group, self.rank, self.size = group, rank, size
        self.gloo = dist.get_backend(group) == 'gloo'

    @classmethod
    def from_mesh(cls, mesh):
        group = mesh.get_group('model')
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def chunk(self, full):
        """(first index, length) of this rank's chunk of ``full``."""
        if full % self.size:
            raise ValueError(f'{full} does not split over tp={self.size}')
        k = full // self.size
        return self.rank * k, k


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _to_backend(ctx, t):
    """``t`` as the backend takes it: on the host for gloo (a counted
    copy of a CUDA tensor), as it is for NCCL."""
    if ctx.gloo and t.is_cuda:
        STAGED['copies'] += 1
        STAGED['bytes'] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_backend(t, like):
    if t.device != like.device:
        STAGED['copies'] += 1
        STAGED['bytes'] += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def _all_gather(ctx, t, dim):
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    src = _to_backend(ctx, t.contiguous())
    if ctx.gloo:
        parts = [torch.empty_like(src) for _ in range(ctx.size)]
        dist.all_gather(parts, src, group=ctx.group)
    else:
        buf = src.new_empty((ctx.size,) + tuple(src.shape))
        dist.all_gather_into_tensor(buf, src, group=ctx.group)
        parts = buf.unbind(0)
    return _from_backend(torch.cat(parts, dim), t)


def _all_reduce(ctx, t, op=dist.ReduceOp.SUM):
    """The ranks' ``t`` reduced (a new tensor)."""
    out = _to_backend(ctx, t)
    out = out.clone() if out is t else out
    dist.all_reduce(out, op=op, group=ctx.group)
    return _from_backend(out, t)


def _reduce_scatter(ctx, t, dim):
    """This rank's chunk along ``dim`` of the ranks' ``t`` summed."""
    lo, k = ctx.chunk(t.shape[dim])
    if ctx.gloo:
        return _all_reduce(ctx, t).narrow(dim, lo, k).contiguous()
    src = torch.stack(t.chunk(ctx.size, dim)).contiguous()
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=ctx.group)
    return out


def _own(ctx, t, dim):
    lo, k = ctx.chunk(t.shape[dim])
    return t.narrow(dim, lo, k).contiguous()


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(ctx, x, x.dim() - 1)

    @staticmethod
    def backward(fctx, g):
        return _reduce_scatter(fctx.ctx, g, g.dim() - 1), None


class _ReplicateChannels(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(ctx, x, x.dim() - 1)

    @staticmethod
    def backward(fctx, g):
        return _own(fctx.ctx, g, g.dim() - 1), None


class _ShardChannels(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _own(ctx, x, x.dim() - 1)

    @staticmethod
    def backward(fctx, g):
        return _all_gather(fctx.ctx, g, g.dim() - 1), None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(fctx, p, ctx, dim):
        fctx.ctx, fctx.dim = ctx, dim
        return _all_gather(ctx, p, dim)

    @staticmethod
    def backward(fctx, g):
        return _own(fctx.ctx, g, fctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_reduce(ctx, x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(fctx.ctx, g), None


def gather_channels(x, ctx):
    """All-gather ``x``'s last dim (channel shards to the whole channels)
    for a column-parallel consumer: the backward reduce-scatters, each
    rank's consumer having given a partial gradient."""
    return _GatherChannels.apply(x, ctx)


def replicate_channels(x, ctx):
    """All-gather ``x``'s last dim for a consumer every model rank runs
    alike: the backward takes this rank's slice of the (equal)
    gradient."""
    return _ReplicateChannels.apply(x, ctx)


def shard_channels(x, ctx):
    """This rank's channels of a value every model rank holds alike; the
    backward all-gathers the shards' gradients."""
    return _ShardChannels.apply(x, ctx)


def gather_param(p, dim, ctx):
    """A sharded weight gathered along ``dim`` for compute every model
    rank replicates; the backward takes this rank's slice."""
    return _GatherParam.apply(p, ctx, dim)


def all_reduce_sum(x, ctx):
    """The sum of ``x`` over the model ranks; the backward sums too."""
    return _AllReduceSum.apply(x, ctx)


class DistributedLayerNorm(nn.Module):
    """LayerNorm over channels sharded on the model ranks: two-pass f32
    statistics (an all-reduce of the row sums for the mean, then of the
    squared deviations), as :class:`~nbasr_torch.models.layers.LayerNorm`
    and the fused kernel; this rank's slice of the replicated ``scale``
    and ``bias`` (the whole cell's parameters, under their names).  The
    backward all-reduces the row sums of the gradient through
    :func:`all_reduce_sum`."""

    def __init__(self, norm, ctx, c0, channels):
        super().__init__()
        self.scale, self.bias = norm.scale, norm.bias
        self.epsilon = norm.epsilon
        self.ctx, self.c0, self.channels = ctx, c0, channels

    def forward(self, x):
        xf = x.float()
        C = self.channels * self.ctx.size
        mu = all_reduce_sum(xf.sum(-1, keepdim=True), self.ctx) / C
        d = xf - mu
        var = all_reduce_sum(torch.square(d).sum(-1, keepdim=True),
                             self.ctx) / C
        y = (d * torch.rsqrt(var + self.epsilon)
             * self.scale.narrow(0, self.c0, self.channels)
             + self.bias.narrow(0, self.c0, self.channels))
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# the model's modules
# ---------------------------------------------------------------------------

class _Adopted(nn.Module):
    """Runs ``inner`` with its parameters, buffers and children held here
    under their own names (so the model keeps every parameter name), each
    parameter of ``views`` seen through its function (a gather or a
    slice) in the call."""

    def __init__(self, inner, ctx, views=None):
        super().__init__()
        for n, p in inner.named_parameters(recurse=False):
            self.register_parameter(n, p)
        for n, b in inner.named_buffers(recurse=False):
            self.register_buffer(n, b)
        for n, m in inner.named_children():
            self.add_module(n, m)
        self.__dict__['inner'] = inner         # not a child: no new names
        self.ctx = ctx
        self.views = dict(views or {})
        self.train(inner.training)

    def train(self, mode=True):
        super().train(mode)
        self.inner.train(mode)
        return self

    def run(self, *args, **kwargs):
        params = dict(self.inner.named_parameters())
        subs = {n: view(params[n]) for n, view in self.views.items()}
        return functional_call(self.inner, subs, args, kwargs)


class ColumnConv(_Adopted):
    """A block conv on this rank's output channels ``[c0, c0 + k)``: the
    input gathered (``gather_input``) or the replicated features, the
    weight's shard (or slice where ``param_spec`` replicates it), the
    bias's slice."""

    def __init__(self, conv, ctx, c0, k, gather_input, weight_sharded):
        sliced = lambda p: p.narrow(0, c0, k)
        views = {'conv.bias': sliced}
        if not weight_sharded:
            views['conv.weight'] = sliced
        super().__init__(conv, ctx, views)
        self.gather_input = gather_input

    def forward(self, x):
        if self.gather_input:
            x = gather_channels(x, self.ctx)
        return self.run(x)


class _Cell(_Adopted):
    """A cell under tensor parallelism; its forward takes and returns this
    rank's channels, or (``gather_output``, the last cell) the whole
    encoder output."""

    def __init__(self, cell, ctx, views, gather_output):
        super().__init__(cell, ctx, views)
        self.gather_output = gather_output

    def draw_seed(self, generator, device):
        return self.inner.draw_seed(generator, device)


class ChannelCell(_Cell):
    """A channel-parallel cell: the whole cell's ``SearchCell`` made over in
    place into this rank's ``C / tp`` channels in ``G / tp`` groups, its
    dropout hash at channel offset ``c0``, its LayerNorm a
    :class:`DistributedLayerNorm` outside the kernel."""

    def forward(self, x, generator=None, seed=None):
        y = self.run(x, generator, seed)
        return replicate_channels(y, self.ctx) if self.gather_output else y


class WholeCell(_Cell):
    """A cell run whole on every model rank: its input gathered, its
    sharded weights gathered; it keeps this rank's shard of the output
    (the whole output with ``gather_output``)."""

    def forward(self, x, generator=None, seed=None):
        y = self.run(replicate_channels(x, self.ctx), generator, seed)
        return y if self.gather_output else shard_channels(y, self.ctx)


class Replicated(_Adopted):
    """A module every model rank runs alike (the LSTM, the head) with its
    sharded weights gathered."""

    def forward(self, *args, **kwargs):
        return self.run(*args, **kwargs)


def _kernel_names(cell):
    """``{node module name: its kernel's name in the module}`` of a cell's
    conv and linear nodes."""
    out = {}
    for name, m in cell.named_children():
        if isinstance(m, GroupedPadConvRelu):
            out[name] = 'conv.weight' if m.impl == 'native' \
                else 'conv_kernel_grouped'
        elif name != 'norm':
            out[name] = 'dense.kernel'
    return out


def _channel_parallel(cell, prefix, shards, tp):
    """Whether a cell runs channel-parallel: conv and zero nodes only,
    groups that ``tp`` divides, and kernels ``param_spec`` shards."""
    kernels = _kernel_names(cell)
    return (all(n.kind in ('conv', 'zero') for n in cell.spec.nodes)
            and cell.groups % tp == 0
            and all(f'{prefix}.{m}.{k}' in shards for m, k in kernels.items()))


def _make_channel_cell(cell, ctx, c0, k, gather_output):
    """Make ``cell`` (its parameters already this rank's shards) over into
    this rank's channels; returns its :class:`ChannelCell`."""
    tp = ctx.size
    views = {}
    for name, m in cell.named_children():
        if isinstance(m, GroupedPadConvRelu):
            m.groups //= tp
            m.channel_offset = c0
            if m.impl == 'native':              # nn.Conv's replicated bias
                views[f'{name}.conv.bias'] = lambda p: p.narrow(0, c0, k)
    cell.groups //= tp
    nodes = [ZeroNode(n.branches) if n.kind == 'zero' else
             ConvNode(n.K, n.d, n.lpad, n.rpad, n.groups // tp, n.cin_pg,
                      n.cout_pg, n.branches) for n in cell.spec.nodes]
    eps = cell.spec.ln_eps
    cell.spec = FusedCellSpec(nodes, ln_eps=eps, use_norm=False,
                              channel_offset=c0)
    cell.train_spec = FusedCellSpec(
        nodes, dropout_rate=cell.train_spec.dropout_rate, train=True,
        ln_eps=eps, use_norm=False, channel_offset=c0)
    if cell.norm is not None:
        cell.norm = DistributedLayerNorm(cell.norm, ctx, c0, k)
    return ChannelCell(cell, ctx, views, gather_output)


def tensor_parallel(model, mesh):
    """Shard ``model`` (an :class:`~nbasr_torch.models.asr.ASRModel`) over
    the mesh's ``'model'`` dim in place, as the module docstring says, and
    return it; a ``'model'`` dim of 1 leaves it as it is.  Sets
    ``model.tp_layout``, ``model.tp_full_shapes`` and ``model.tp_group``
    (a :class:`ModelGroup`)."""
    ctx = ModelGroup.from_mesh(mesh)
    tp = ctx.size
    if tp == 1:
        return model
    if model.grouped_impl == 'pallas_split' and model.cell_groups > 1:
        raise NotImplementedError(TP_LATER)
    if any(c % tp for c in model.block_filters):
        raise ValueError(f'block widths {model.block_filters} do not split '
                         f'over tp={tp}')
    if not model.cells_per_block or model.cells_per_block[-1] < 1:
        raise ValueError('tensor parallelism gathers the encoder output '
                         'after the last cell: the last block needs one')
    placements = param_shardings(model, mesh)
    shards = {n: pl[1].dim for n, pl in placements.items()
              if pl[1].is_shard()}
    full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    # every sharded parameter becomes this rank's slice, under its name
    with torch.no_grad():
        for name, dim in shards.items():
            owner, _, leaf = name.rpartition('.')
            module = model.get_submodule(owner)
            p = getattr(module, leaf)
            setattr(module, leaf, nn.Parameter(
                _own(ctx, p.detach(), dim).clone(),
                requires_grad=p.requires_grad))

    layout = {n: ('shard', d) for n, d in shards.items()}
    sliced = lambda name, dim=0: layout.setdefault(name, ('slice', dim))
    last_block = len(model.cells_per_block) - 1
    for i, cells in enumerate(model.cells_per_block):
        c0, k = ctx.chunk(model.block_filters[i])
        conv = f'block{i}_conv'
        setattr(model, conv, ColumnConv(
            getattr(model, conv), ctx, c0, k, gather_input=i > 0,
            weight_sharded=f'{conv}.conv.weight' in shards))
        sliced(f'{conv}.conv.weight')
        sliced(f'{conv}.conv.bias')
        norm = f'block{i}_norm'
        setattr(model, norm, DistributedLayerNorm(getattr(model, norm), ctx,
                                                  c0, k))
        sliced(f'{norm}.scale')
        sliced(f'{norm}.bias')
        for j in range(cells):
            prefix = f'block{i}_cell{j}'
            cell = getattr(model, prefix)
            last = i == last_block and j == cells - 1
            if _channel_parallel(cell, prefix, shards, tp):
                new = _make_channel_cell(cell, ctx, c0, k, last)
                for v in new.views:
                    sliced(f'{prefix}.{v}')
                if cell.norm is not None:
                    sliced(f'{prefix}.norm.scale')
                    sliced(f'{prefix}.norm.bias')
            else:
                new = WholeCell(cell, ctx, {
                    n[len(prefix) + 1:]: _gatherer(d, ctx)
                    for n, d in shards.items()
                    if n.startswith(prefix + '.')}, last)
            setattr(model, prefix, new)
    for name in ('lstm', 'head'):
        module = getattr(model, name, None)
        views = {n[len(name) + 1:]: _gatherer(d, ctx)
                 for n, d in shards.items() if n.startswith(name + '.')}
        if module is not None and views:
            setattr(model, name, Replicated(module, ctx, views))
    names = [n for n, _ in model.named_parameters()]
    if names != list(full_shapes):
        raise RuntimeError('tensor_parallel changed the parameter names or '
                           'their order')
    model.tp_layout = {n: layout.get(n, ('whole', None)) for n in names}
    model.tp_full_shapes = full_shapes
    model.tp_group = ctx
    return model


def _gatherer(dim, ctx):
    return lambda p: gather_param(p, dim, ctx)


# ---------------------------------------------------------------------------
# what the trainer needs
# ---------------------------------------------------------------------------

def _sliced(model):
    return [p for n, p in model.named_parameters()
            if model.tp_layout[n][0] == 'slice' and p.grad is not None]


def sum_sliced_grads(model):
    """Sum over ``'model'`` the gradients of the replicated parameters the
    compute uses sliced (``tp_layout`` ``'slice'``), in one all-reduce."""
    params = _sliced(model)
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    flat = _all_reduce(model.tp_group, flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def conv_l2(model):
    """:func:`nbasr_torch.training.loss.conv_l2` of the whole model from
    this rank's parameters: the squares of its shards and of its slices of
    sliced kernels, all-reduced over ``'model'`` for the value (their
    gradient stays local), plus the squares of the kernels every rank uses
    whole."""
    ctx = model.tp_group
    local = whole = 0.0
    for name, p in model.named_parameters():
        if not _is_conv_kernel(name):
            continue
        kind, dim = model.tp_layout[name]
        if kind == 'whole':
            whole = whole + p.float().square().sum()
        else:
            part = p if kind == 'shard' else _own(ctx, p, dim)
            local = local + part.float().square().sum()
    if torch.is_tensor(local):
        local = local + (_all_reduce(ctx, local.detach()) - local.detach())
    return L2_COEFF * (local + whole)


def grad_norm_sq(model, params):
    """Squared global norm of ``params``' gradients: the shards' squares
    summed over ``'model'``, each replicated parameter counted once."""
    sharded = {id(p) for n, p in model.named_parameters()
               if model.tp_layout[n][0] == 'shard'}
    sq = torch.zeros(2, device=params[0].grad.device)
    for p in params:
        sq[0 if id(p) in sharded else 1] += p.grad.float().square().sum()
    return _all_reduce(model.tp_group, sq[0]) + sq[1]


def all_reduce_max(t):
    """The largest of ``t`` over every rank of the default group."""
    world = ModelGroup(None, dist.get_rank(), dist.get_world_size())
    return _all_reduce(world, t, dist.ReduceOp.MAX)


def gather_named(model, tensors):
    """``{name: whole tensor}`` of ``{name: this rank's tensor}`` shaped
    like the parameters (values, gradients, Adam moments): shards gathered
    over ``'model'``, everything else as it is.  A collective: every model
    rank calls it."""
    out = {}
    for name, t in tensors.items():
        kind, dim = model.tp_layout.get(name, ('whole', None))
        out[name] = _all_gather(model.tp_group, t, dim) \
            if kind == 'shard' else t
    return out


def shard_named(model, tensors):
    """Inverse of :func:`gather_named`: this rank's slice of each sharded
    name's whole tensor."""
    out = {}
    for name, t in tensors.items():
        kind, dim = model.tp_layout.get(name, ('whole', None))
        out[name] = _own(model.tp_group, t, dim) if kind == 'shard' else t
    return out
