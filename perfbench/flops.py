"""Operation and byte counts, and the published peaks they are held to.

A whole step's FLOPs are its architecture's (``algorithmic_flops`` of
``perfbench/archs/<model>.py``).  ``cell_counts`` counts one NAS-Bench-ASR
search cell's forward or backward at its shapes: the operations of its
conv and linear nodes (a backward is dx plus dW, each at the forward's
multiply-adds) and its bytes, each input read once and each output
written once, whatever implements it.
"""

from .archs.nas_bench_asr import CONVS, arch_nodes

__all__ = ['PEAK_FLOPS', 'PEAK_BYTES_PER_S', 'cell_counts', 'least_seconds',
           'mfu']

#: One H100 SXM's dense peaks (NVIDIA's data sheet, at 700 W): operations
#: a second by the dtype's bytes (bf16 on the tensor cores, f32 outside
#: them) and HBM3 bytes a second.
PEAK_FLOPS = {2: 989e12, 4: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def cell_counts(cfg, B, T, C, esize, backward=False):
    """``(operations, bytes)`` of one cell call on ``[B, T, C]``
    activations of ``esize`` bytes; parameters (f32) count 4 bytes."""
    G = cfg['cell_groups']
    ci = C // G
    ops = 0.0
    params = 2 * C                              # the LayerNorm
    for op, _ in arch_nodes(cfg['arch_vec']):
        if op == 'linear':
            ops += 2.0 * B * T * C * C
            params += C * C + C
        elif op in CONVS:
            K = CONVS[op][0]
            ops += 2.0 * B * T * K * G * ci * ci
            params += K * ci * C + C
    act = B * T * C * esize
    if backward:          # dy, x and the parameters in; dx and their grads out
        return 2.0 * ops, 3.0 * act + 8.0 * params
    return ops, 2.0 * act + 4.0 * params


def least_seconds(ops, nbytes, esize):
    """The least time the chip could take: operations over the dtype's
    peak or bytes over the memory's, whichever is larger."""
    return max(ops / PEAK_FLOPS[esize], nbytes / PEAK_BYTES_PER_S)


def mfu(flops, seconds, esize):
    """``flops`` in ``seconds`` as a share (%) of the dtype's peak."""
    return 100.0 * flops / (seconds * PEAK_FLOPS[esize]) if seconds else None


