"""Sequence parallelism: the encoder's time halo and time-sharded
execution of the model, the counterpart of
``nbasr_tpu/parallel/seqparallel.py``.

A window of features extended by ``encoder_halo(model)`` frames on each
side computes the global encoder output on its interior, which is what
exact chunked serving and :func:`seq_parallel_apply` rely on.
:func:`seq_parallel_apply` runs one process per time shard (a
``torch.distributed`` group, one rank per device): each rank exchanges
``m = hl + hr`` edge frames with its neighbours, cuts a window of ``L + m``
frames clipped at the global edges (where the model's own padding is the
global computation's), builds the mask from global frame positions, runs
the unmodified model's ``stage='encode'`` and trims; the head then relays
the LSTM carry rank by rank (``'chain'``) or all-gathers the ×4-reduced
encoder output and runs replicated (``'gather'``).  The cells run the
fused kernel on every window.  The exchange follows the group's backend:
NCCL sends CUDA tensors (``batch_isend_irecv``), gloo host tensors
(``isend``/``irecv``, a CUDA tensor copied each way).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import conv_padding

__all__ = ['encoder_halo', 'seq_parallel_apply']

_OP_CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2),
             'conv7': (7, 1), 'conv7d2': (7, 2)}


def _op_pads(op_name):
    if op_name in _OP_CONVS:
        k, d = _OP_CONVS[op_name]
        return conv_padding(k, d, 1)
    return (0, 0)  # linear / zero / skip are pointwise in time


def encoder_halo(model):
    """(left, right) input-frame halo for exact windowed execution.

    Walks the blocks back to front: a cell's node pads add up, a block conv
    scales the downstream need by its stride and adds its own pads.
    Rounded up to the total time reduction so trims stay integral.
    """
    need_l = need_r = 0
    blocks = list(zip(model.block_kernels, model.block_strides,
                      model.cells_per_block))
    for kernel, stride, cells in reversed(blocks):
        need_l += cells * sum(_op_pads(n[0])[0] for n in model.arch_desc)
        need_r += cells * sum(_op_pads(n[0])[1] for n in model.arch_desc)
        lp, rp = conv_padding(kernel, 1, stride)
        need_l = need_l * stride + lp
        need_r = need_r * stride + rp
    total = int(np.prod(model.block_strides))
    up = lambda v: int(-(-v // total) * total)
    return up(need_l), up(need_r)


def _exchange(sends, recvs, group):
    """Point-to-point ``sends`` (tensor, group rank) and ``recvs`` (buffer,
    group rank) in one round; returns the received buffers on their own
    device."""
    peer = (lambda r: r) if group is None else \
        (lambda r: dist.get_global_rank(group, r))
    if dist.get_backend(group) == 'nccl':
        ops = ([dist.P2POp(dist.isend, t.contiguous(), peer(r), group)
                for t, r in sends]
               + [dist.P2POp(dist.irecv, b, peer(r), group) for b, r in recvs])
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return [b for b, _ in recvs]
    works = [dist.isend(t.detach().cpu().contiguous(), peer(r), group)
             for t, r in sends]
    host = [(torch.empty(b.shape, dtype=b.dtype), r) for b, r in recvs]
    works += [dist.irecv(h, peer(r), group) for h, r in host]
    for work in works:
        work.wait()
    return [h.to(b.device) for (h, _), (b, _) in zip(host, recvs)]


def seq_parallel_apply(model, features, feature_size, group=None,
                       lstm_mode='chain', generator=None):
    """``model`` over a time-sharded batch, one rank of ``group`` (default:
    the whole process group) per shard.

    Each rank passes its shard ``[B, T/n, F]`` of the features (rank order
    is time order) and the global ``feature_size [B]``, and gets back its
    shard ``[B, T/(n*stride), V]`` of the logits.  ``T`` must be divisible
    by n × the total stride, and each shard at least the total halo long.
    Exact against the unsharded forward up to float reassociation; in
    training mode each shard draws its own dropout masks from
    ``generator``, as the JAX version's shards do."""
    if lstm_mode not in ('chain', 'gather'):
        raise ValueError(f'unknown lstm_mode: {lstm_mode!r}')
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    B, L, F = features.shape
    T = L * n
    ts = int(np.prod(model.block_strides))
    if T % (n * ts):
        raise ValueError(f'T={T} not divisible by seq={n} x stride={ts}')
    hl, hr = encoder_halo(model)
    m = hl + hr
    if L < m:
        raise ValueError(
            f'shard length {L} < total halo {m} = {hl}+{hr}; '
            f'use at most seq={T // m} shards for T={T}')
    # m edge frames each way, then a window of L + m frames clipped to the
    # sequence (offsets stay multiples of the total stride)
    sends, recvs = [], []
    left = features.new_zeros((B, m, F))
    right = features.new_zeros((B, m, F))
    if idx > 0:
        sends.append((features[:, :m], idx - 1))
        recvs.append((left, idx - 1))
    if idx < n - 1:
        sends.append((features[:, L - m:], idx + 1))
        recvs.append((right, idx + 1))
    got = iter(_exchange(sends, recvs, group))
    left = next(got) if idx > 0 else left
    right = next(got) if idx < n - 1 else right
    buf = torch.cat([left, features, right], dim=1)        # [B, L + 2m, F]
    L_ext = L + m
    w = min(max(idx * L - hl, 0), T - L_ext)               # window start
    off = w - (idx * L - m)
    ext = buf[:, off:off + L_ext]
    pos = w + torch.arange(L_ext, device=features.device)
    mask = pos[None, :] < feature_size.to(features.device)[:, None]
    enc = model(ext, mask=mask, stage='encode', generator=generator)
    lo = (idx * L - w) // ts
    enc = enc[:, lo:lo + L // ts]

    if not model.use_rnn:
        return model(enc, stage='head', generator=generator)
    if lstm_mode == 'gather':       # the x4-reduced features, head replicated
        parts = [torch.empty_like(enc) for _ in range(n)]
        if dist.get_backend(group) == 'nccl':
            dist.all_gather(parts, enc.contiguous(), group=group)
        else:
            host = [p.cpu() for p in parts]
            dist.all_gather(host, enc.detach().cpu().contiguous(),
                            group=group)
            parts = [h.to(enc.device) for h in host]
        logits = model(torch.cat(parts, dim=1), stage='head',
                       generator=generator)
        return logits[:, idx * (L // ts):(idx + 1) * (L // ts)]
    # 'chain': the (c, h) carry relayed shard by shard
    carry = None
    if idx > 0:
        H = model.rnn_units
        c = enc.new_empty((B, H), dtype=model.compute_dtype)
        carry = tuple(_exchange([], [(c, idx - 1), (torch.empty_like(c),
                                                     idx - 1)], group))
    logits, carry = model(enc, stage='head', rnn_carry=carry,
                          return_rnn_carry=True, generator=generator)
    if idx < n - 1:
        _exchange([(carry[0], idx + 1), (carry[1], idx + 1)], [], group)
    return logits
