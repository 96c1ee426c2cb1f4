"""Operation, byte and FLOP counts against hand counts at small shapes."""

import math

import pytest

from perfbench import flops
from perfbench.archs import nas_bench_asr as nas

TINY = {'arch_vec': [[1, 0], [1, 0, 0], [1, 0, 0, 0]],
        'block_kernels': [8, 8], 'block_strides': [1, 2],
        'block_filters': [8, 12], 'cells_per_block': [1, 2],
        'cell_groups': 4, 'rnn_units': 5, 'num_classes': 48}


def test_cell_forward_counts_by_hand():
    # three conv5 nodes, C=8 in 4 groups of 2: each 2*B*T*K*G*ci*ci
    B, T, C = 2, 3, 8
    ops, nbytes = flops.cell_counts(TINY, B, T, C, esize=2)
    assert ops == 3 * 2 * B * T * 5 * 4 * 2 * 2
    params = 3 * (5 * 2 * 8 + 8) + 2 * 8
    assert nbytes == 2 * B * T * C * 2 + 4 * params


def test_cell_backward_is_dx_plus_dw():
    ops, nbytes = flops.cell_counts(TINY, 2, 3, 8, esize=4, backward=True)
    fwd_ops, _ = flops.cell_counts(TINY, 2, 3, 8, esize=4)
    assert ops == 2 * fwd_ops
    params = 3 * (5 * 2 * 8 + 8) + 2 * 8
    assert nbytes == 3 * 2 * 3 * 8 * 4 + 8 * params


def test_linear_node_counts_dense():
    cfg = {**TINY, 'arch_vec': [[0, 1], [5, 0, 0], [5, 0, 0, 0]]}
    ops, nbytes = flops.cell_counts(cfg, 1, 10, 8, esize=2)
    assert ops == 2 * 10 * 8 * 8
    assert nbytes == 2 * 10 * 8 * 2 + 4 * (8 * 8 + 8 + 2 * 8)


def test_least_seconds_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0, 2) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12, 2) == pytest.approx(1.0)
    assert flops.least_seconds(67e12, 3.35e12 / 2, 4) == pytest.approx(1.0)


@pytest.mark.parametrize('train', [False, True])
def test_algorithmic_flops_by_hand(train):
    B, T = 2, 10
    t1, t2 = 10, 5
    fwd = (2 * B * t1 * 8 * 80 * 8 + 3 * 2 * B * t1 * 4 * 2 * 2 * 5
           + 2 * B * t2 * 8 * 8 * 12 + 2 * 3 * 2 * B * t2 * 4 * 3 * 3 * 5
           + 2 * B * t2 * 4 * 5 * (12 + 5) + 2 * B * t2 * 5 * 49)
    assert nas.algorithmic_flops(TINY, B, T, train) == fwd * (3 if train
                                                               else 1)


def test_algorithmic_flops_match_the_port():
    from nbasr_torch.models.asr import algorithmic_flops, get_model
    for arch in ([[1, 0], [1, 0, 0], [1, 0, 0, 0]],
                 [[0, 1], [2, 1, 0], [4, 0, 1, 1]]):
        cfg = {**TINY, 'arch_vec': arch}
        model = get_model(arch, device='cpu', block_kernels=(8, 8),
                          block_strides=(1, 2), block_filters=(8, 12),
                          cells_per_block=(1, 2), cell_groups=4, rnn_units=5)
        assert math.isclose(nas.algorithmic_flops(cfg, 3, 17),
                            algorithmic_flops(model, 3, 17))


def test_mfu_share():
    assert flops.mfu(989e12, 2.0, 2) == pytest.approx(50.0)
    assert flops.mfu(1.0, 0.0, 2) is None
