"""Fused SearchCell forward: the Hopper kernel's wrapper and its plain version.

Port of ``nbasr_tpu/ops/fused_cell.py`` ``_fwd_kernel`` at ``train=False``:
one whole cell — every node's grouped conv or dense product, bias,
clip-ReLU(20), branch adds, and the trailing LayerNorm — per call.  The
kernel is ``nbasr_torch/csrc/fused_cell.cu``; its header states the bound
and the design.  The TPU layout tricks (chunk expansion, 128-lane padding)
are not carried over: the kernel reads the compact ``[K, ci, C]`` weights.

:func:`fused_cell_forward` runs the kernel on a CUDA tensor and the plain
version :func:`fused_cell_reference` on a CPU tensor, and nothing else:
there is no fallback from one to the other.  ``LAUNCHES`` counts the calls
of each, so a run can show which one it went through.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ['ConvNode', 'LinearNode', 'ZeroNode', 'FusedCellSpec',
           'fused_cell_forward', 'fused_cell_reference', 'LAUNCHES',
           'reset_launches']

LN_EPS_DEFAULT = 1e-3

#: Calls of the CUDA kernel (``'kernel'``) and of the plain version
#: (``'plain'``) since the last :func:`reset_launches`.
LAUNCHES = {'kernel': 0, 'plain': 0}

_KIND = {'conv': 0, 'linear': 1, 'zero': 2}
_MAX_NODES = 7          # kMaxOutputs - 1 in the kernel


def reset_launches():
    LAUNCHES.update(kernel=0, plain=0)


class ConvNode:
    """A grouped dilated conv node: tap k reads ``x[t + k*d - lpad]``."""

    kind = 'conv'

    def __init__(self, kernel_size, dilation, lpad, rpad, groups, cin_pg,
                 cout_pg, branches):
        if lpad + rpad != (kernel_size - 1) * dilation:
            raise ValueError(f'padding ({lpad}, {rpad}) does not keep the '
                             f'length for K={kernel_size}, d={dilation}')
        self.K = kernel_size
        self.d = dilation
        self.lpad = lpad
        self.rpad = rpad
        self.groups = groups
        self.cin_pg = cin_pg
        self.cout_pg = cout_pg
        self.branches = tuple(branches)   # indices into the outputs list


class LinearNode:
    kind = 'linear'

    def __init__(self, branches):
        self.branches = tuple(branches)


class ZeroNode:
    kind = 'zero'

    def __init__(self, branches):
        self.branches = tuple(branches)


class FusedCellSpec:
    """Static description of a cell: its nodes, then LayerNorm or not."""

    def __init__(self, nodes, ln_eps=LN_EPS_DEFAULT, use_norm=True):
        self.nodes = tuple(nodes)
        self.ln_eps = float(ln_eps)
        self.use_norm = bool(use_norm)


def fused_cell_forward(spec, x, weights, ln):
    """Run one cell.

    ``x [B, T, C]`` f32 or bf16; ``weights``: flat per-node ``(w, b)`` in
    node order, zero nodes taking none — conv ``w`` compact ``[K, ci, C]``,
    linear ``w [C, C]``, both in ``x.dtype``, ``b [C]`` f32; ``ln``:
    ``(scale [C], bias [C])`` f32, ignored when ``spec.use_norm`` is False.
    """
    if x.device.type == 'cpu':
        return fused_cell_reference(spec, x, weights, ln)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_cell_forward runs on cuda or cpu, '
                         f'not {x.device}')
    return _launch(spec, x, weights, ln)


def fused_cell_reference(spec, x, weights, ln):
    """The plain PyTorch version of the kernel, with the same rounding
    points: f32 sums and bias, node outputs rounded to ``x.dtype``, f32
    LayerNorm statistics, the result rounded to ``x.dtype``."""
    LAUNCHES['plain'] += 1
    B, T, C = x.shape
    outs = [x]
    wi = 0
    for node in spec.nodes:
        src = outs[-1].float()
        if node.kind == 'zero':
            total = torch.zeros((B, T, C), dtype=torch.float32,
                                device=x.device)
        else:
            w, b = weights[wi].float(), weights[wi + 1]
            wi += 2
            if node.kind == 'conv':
                xp = F.pad(src.transpose(1, 2), (node.lpad, node.rpad))
                acc = F.conv1d(xp, w.permute(2, 1, 0), dilation=node.d,
                               groups=node.groups).transpose(1, 2)
            else:
                acc = src @ w
            total = torch.clamp(acc + b, 0.0, 20.0)
        for j in node.branches:
            total = total + outs[j].float()
        outs.append(total.to(x.dtype))
    xf = outs[-1].float()
    if spec.use_norm:
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + spec.ln_eps) * ln[0] + ln[1]
    return xf.to(x.dtype)


def _lib():
    lib = _build.load('fused_cell')
    fn = lib.nbasr_fused_cell_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.nbasr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nbasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f'{name}: expected a contiguous {dtype} tensor of '
                         f'shape {tuple(shape)} on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')


def _launch(spec, x, weights, ln):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'the fused cell kernel takes f32 or bf16, '
                         f'not {x.dtype}')
    B, T, C = x.shape
    _check(x, 'x', (B, T, C), x.dtype, x.device)
    n = len(spec.nodes)
    if not 1 <= n <= _MAX_NODES:
        raise ValueError(f'the fused cell kernel takes 1..{_MAX_NODES} '
                         f'nodes, got {n}')
    desc, wptrs, bptrs = [], [], []
    wi = 0
    for i, node in enumerate(spec.nodes):
        if any(not 0 <= j <= i for j in node.branches):
            raise ValueError(f'node {i}: branches {node.branches} must '
                             f'index outputs 0..{i}')
        mask = sum(1 << j for j in set(node.branches))
        if node.kind == 'zero':
            desc += [_KIND['zero'], 0, 0, 0, 0, 0, mask]
            wptrs.append(None)
            bptrs.append(None)
            continue
        w, b = weights[wi], weights[wi + 1]
        wi += 2
        if node.kind == 'conv':
            if node.groups * node.cin_pg != C or node.groups * node.cout_pg != C:
                raise ValueError(f'node {i}: {node.groups} groups of '
                                 f'{node.cin_pg}/{node.cout_pg} do not make '
                                 f'C={C}')
            _check(w, f'node {i} weight', (node.K, node.cin_pg, C), x.dtype,
                   x.device)
            desc += [_KIND['conv'], node.K, node.d, node.lpad, node.cin_pg,
                     node.cout_pg, mask]
        else:
            _check(w, f'node {i} weight', (C, C), x.dtype, x.device)
            desc += [_KIND['linear'], 0, 0, 0, 0, 0, mask]
        _check(b, f'node {i} bias', (C,), torch.float32, x.device)
        wptrs.append(w.data_ptr())
        bptrs.append(b.data_ptr())
    if spec.use_norm:
        for t, name in zip(ln, ('ln scale', 'ln bias')):
            _check(t, name, (C,), torch.float32, x.device)
        ln_ptrs = [ln[0].data_ptr(), ln[1].data_ptr()]
    else:
        ln_ptrs = [None, None]

    scratch = torch.empty((n, B, T, C), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nbasr_fused_cell_forward(
            int(x.dtype == torch.bfloat16), B, T, C, n,
            (ctypes.c_int * len(desc))(*desc),
            (ctypes.c_void_p * n)(*wptrs), (ctypes.c_void_p * n)(*bptrs),
            x.data_ptr(), scratch.data_ptr(), y.data_ptr(), *ln_ptrs,
            int(spec.use_norm), spec.ln_eps, stream)
    if err:
        raise RuntimeError('fused cell kernel launch failed: '
                           + lib.nbasr_cuda_error_string(err).decode())
    LAUNCHES['kernel'] += 1
    return y
