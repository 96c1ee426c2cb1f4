"""The Conformer-CTC architecture of the benchmark (archs/conformer_ctc.py)
on the CPU at a reduced width: its reference agrees with the tests' own
copy (tests/conformer_reference.py), its parameter table names the port's
parameters, and its cell runs end to end, held to that reference."""

import sys
import time

import pytest
import torch

from conftest import MIXES, ROOT
from perfbench import faults, run, weights
from perfbench.archs import conformer_ctc as arch
from perfbench.reference import frontend as fe
from perfbench.reference import model as ref

sys.path.insert(0, str(ROOT / 'tests'))
import conformer_reference as tests_ref  # noqa: E402

CPU = torch.device('cpu')
SMALL = {'num_blocks': 2, 'd_model': 32, 'num_heads': 2, 'ffn_dim': 64,
         'conv_kernel': 8}
#: leaves whose gradient is zero: k's bias (a constant a row under the
#: softmax) and the depthwise bias (a constant a channel under the
#: BatchNorm)
ZERO_GRADIENT = ('mhsa.k.bias', 'depthwise.conv.bias')
MIX = {**MIXES['train'], 'duration_median_s': 2.0, 'duration_s': [1.0, 4.0],
       'bucket_boundary': 200}


def _cfg():
    return {**run.cell_spec('conformer-l.train')[1], **SMALL}


@pytest.mark.parametrize('dropout', [False, True])
def test_the_reference_agrees_with_the_tests_copy(dropout):
    cfg = _cfg()
    p = {k: v.requires_grad_(True)
         for k, v in weights.generate(cfg, 2 ** 31 + 5, CPU).items()}
    audio = torch.randn(3, 400 + 119 * 160) * 0.1
    feats, fsize = fe.log_mel(audio), torch.tensor([120, 90, 37])
    stats = ref.load_stats()
    gen = (lambda: torch.Generator().manual_seed(3)) if dropout else \
        (lambda: None)
    got = arch.forward(p, cfg, feats, fsize, stats, gen())
    want = tests_ref.forward(p, cfg, feats, fsize, stats, gen())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g1 = torch.autograd.grad(got.square().sum(), list(p.values()))
    g2 = torch.autograd.grad(want.square().sum(), list(p.values()))
    top = max(float(b.abs().max()) for b in g2)
    for name, a, b in zip(p, g1, g2):
        if name.endswith(ZERO_GRADIENT):     # rounding alone, both sides
            assert max(float(a.abs().max()), float(b.abs().max())) \
                < 1e-4 * top, name
            continue
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-4 * float(b.abs().max()), msg=name)


def test_the_table_names_the_ports_parameters():
    from nbasr_torch.models.conformer import get_conformer
    cfg = _cfg()
    model = get_conformer(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64,
                          conv_kernel=8, device='cpu')
    table = [(n, tuple(s)) for n, s, _, _ in arch.param_table(cfg)]
    assert len(table) == len(dict(table))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        dict(table)
    assert {n for n, _ in model.named_parameters() if arch.regularised(n)} \
        == {n for n, _ in model.named_parameters()
            if n.endswith('.conv.weight')}
    full = run.cell_spec('conformer-l.train')[1]
    assert sum(torch.Size(s).numel() for _, s, _, _ in
               arch.param_table(full)) == 114_883_121
    with pytest.raises(NotImplementedError):
        arch.halo(full)


def test_a_run_without_attention_calls_reads_no_roofline():
    assert arch.attention_roofline({}) is None
    assert arch.attention_roofline({'spans': None}, backward=True) is None


def _run(trace=0):
    return run.run_cell('conformer-l.train', 2 ** 31 + 17, 1.0, trace, CPU,
                        {'config': SMALL, 'mix': MIX}, t0=time.perf_counter())


@pytest.mark.parametrize('trace', [0, 1])
def test_the_cell_runs_and_holds_to_the_reference(trace):
    r = _run(trace)
    assert r['correct'], r['checks']
    assert r['checks']['logit']['value'] < 1e-5, r['checks']
    want = {0: {'train_audio_s_per_s', 'setup_s'}, 1: {'mfu.train'}}[trace]
    assert set(r['metrics']) == want


def test_a_state_left_unchanged_is_not_correct():
    with faults.planted('train', 'unchanged'):
        r = _run()
    assert not r['correct'], r['checks']
