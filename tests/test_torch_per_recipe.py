"""The port's learning proof on the CPU: its copy of the tone-coded corpus
against ``tests/test_per_recipe.py``'s, bit for bit; the 40-epoch recipe
with the JAX test's three asserts (slow, as the JAX test is); both
tools, ``nbasr_torch.tools.per_run`` and ``quant_per_check``, run end to
end through their ``main`` at 1 epoch with ``--device cpu``, printing
valid JSON;
``recipe_seeds`` over two seeds, its judge and summary; and the witness
switches of ``nbasr_torch.ops.plain``."""

import json

import numpy as np
import pytest
import torch

import tests.test_per_recipe as jax_recipe

from nbasr_torch.tools import per_run, quant_per_check


@pytest.fixture
def one_thread():
    """One intra-op thread: the beam search's thousands of small ops a
    batch run no faster on more, and the suite's other workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('n,seed,n_tones', [(48, 0, 4), (8, 1, 4),
                                            (32, 1, 4), (16, 0, 20)])
def test_tone_split_equals_jax_tests(monkeypatch, n, seed, n_tones):
    """Audio and labels equal the JAX test's ``make_tone_split`` exactly,
    the four tones and ``per_flagship_run.py``'s ``N_TONES`` spread."""
    freqs = per_run.tone_freqs(n_tones)
    if n_tones != 4:     # per_flagship_run.py sets the test module's tones
        monkeypatch.setattr(jax_recipe, 'TONE_FREQS',
                            np.geomspace(300.0, 6000.0, n_tones))
    want = jax_recipe.make_tone_split(n, seed, name='X')
    got = per_run.make_tone_split(n, seed, name='X', freqs=freqs)
    assert len(got) == len(want) == n and got.name == want.name
    for a, b in zip(got.audio, want.audio):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.labels, want.labels):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tone_loaders_give_the_jax_tests_batches():
    """``tone_loaders()`` batches (B=8, 48 train and 8 val utterances) hold
    the JAX test's loaders' arrays, train shuffled alike."""
    got, want = per_run.tone_loaders(), jax_recipe.tone_loaders()
    assert got[0].vocab_size == want[0].vocab_size == 49
    for i in (1, 2):
        for a, b in zip(got[i], want[i]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
    assert got[2] is got[3]


def test_window_stats():
    curve = [0.9, 0.8, 0.6, 0.7, 0.5, 0.55]
    s = per_run.window_stats(curve, window=2)
    assert s['best'] == 0.5 and s['best_epoch'] == 5
    assert s['window_means'] == pytest.approx([0.85, 0.65, 0.525])
    assert s['best_window'] == pytest.approx(0.525)
    assert per_run.window_stats(curve[:1], window=2)['best_window'] is None


def _json_line(capsys, main, args):
    """The last line ``main(args + ['--device', 'cpu', '--json'])`` prints,
    parsed, and the readings it returns."""
    got = main(args + ['--device', 'cpu', '--json'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    return line


def test_per_run_cli_one_epoch_prints_json(capsys, one_thread):
    """``per_run`` at 1 epoch, 16 train utterances, f32, reduced width:
    the readings' keys, finite values, one epoch of each curve."""
    got = _json_line(capsys, per_run.main, [
        '1', '1e-3', '16', '0.2', '1', 'f32', '--block_filters',
        '16,16,24,24', '--cells_per_block', '1,1,1,1', '--cell_groups', '4',
        '--rnn_units', '16'])
    for key in ('val_ler', 'ctc_loss', 'val_ctc_loss', 'epoch_seconds'):
        assert len(got[key]) == 1 and np.isfinite(got[key][0]), key
    assert set(got['test']) == {'val_ctc_loss', 'val_wer', 'val_ler'}
    assert got['best_epoch'] == 1 and got['window_means'] == []
    assert got['seconds'] > 0


def test_quant_per_check_cli_one_epoch_prints_json(capsys, one_thread):
    """``quant_per_check`` at 1 epoch: the f32 and int8 evaluations of
    the same weights and the int8 logits' relative L2 against f32."""
    got = _json_line(capsys, quant_per_check.main, ['--epochs', '1'])
    for part in ('f32', 'int8'):
        assert set(got[part]) == {'ctc_loss', 'wer', 'ler'}
        assert all(np.isfinite(v) for v in got[part].values())
    assert 0 < got['rel_l2'] < 0.1
    assert len(got['val_ler']) == 1


@pytest.mark.slow
def test_recipe_reaches_per_below_half():
    """``tests/test_per_recipe.py``'s recipe through the port on the CPU:
    40 epochs at lr 1e-3, beam W=12; the best val LER under 0.5, the test
    eval (on the remembered best weights) under 0.6, and epoch 1 above
    0.6 (chance for four symbols is ~0.75 and up)."""
    loaders, trainer, model = quant_per_check.build('cpu')
    history, test_scores = trainer.train(model, epochs=40, lr=1e-3)
    best = min(history['val_ler'])
    assert best < 0.5, history['val_ler']
    assert test_scores['val_ler'] < 0.6, test_scores
    assert history['val_ler'][0] > 0.6


def test_recipe_seeds_runs_each_seed(one_thread):
    """``recipe_seeds`` on the CPU: the step witness on the recipe's first
    batch (one route, so kernels and plain agree exactly; a nudge moves
    the gradients), then the recipe once from each seed (here 1 epoch
    each), the first seed twice with the same curve, and the summary."""
    from nbasr_torch.tools import recipe_seeds
    got = recipe_seeds.main(['--seeds', '2', '--epochs', '1', '--nudges',
                             '1', '--device', 'cpu'])
    w = got['witness']
    assert max(w['kernels vs plain'].values()) == 0.0
    assert 0 < max(w['kernels nudged'].values()) < 1e-3
    assert len(w['cells']) == 4 and w['cells'][0]['dx'] == 0.0
    runs = got['runs']['cpu']
    assert [r['seed'] for r in runs] == [0, 1] and got['repeats'] is True
    for run in runs:
        assert len(run['val_ler']) == 1 and run['best_epoch'] == 1
    assert runs[0]['val_ler'] != runs[1]['val_ler']
    assert got['summary']['cpu']['runs'] == 2


def _run(best, test, first):
    return dict(best=best, test=dict(val_ler=test), val_ler=[first, best])


@pytest.mark.parametrize('run,ok', [
    (_run(0.1, 0.2, 0.9), True), (_run(0.5, 0.2, 0.9), False),
    (_run(0.1, 0.6, 0.9), False), (_run(0.1, 0.2, 0.6), False)])
def test_recipe_seeds_passes_is_the_jax_tests_three_asserts(run, ok):
    from nbasr_torch.tools import recipe_seeds
    assert recipe_seeds.passes(run) is ok


def test_recipe_seeds_summary_compares_two_routes():
    from nbasr_torch.tools import recipe_seeds
    a = [_run(b, b, 0.9) for b in (0.0, 0.1, 0.2, 0.7)]
    b = [_run(b, b, 0.8) for b in (0.0, 0.3, 0.55, 0.9)]
    s = recipe_seeds.routes_summary({'kernels': a, 'plain': b})
    assert s['kernels']['passing'] == 3 and s['plain']['passing'] == 2
    assert s['kernels']['median_best'] == pytest.approx(0.15)
    assert s['plain']['least_first'] == 0.8
    assert 0.0 < s['rank_sum_p'] <= 1.0


@pytest.mark.parametrize('switch,module,names', [
    ('plain_cells', 'fused_cell',
     ('fused_cell_train_forward', 'fused_cell_backward')),
    ('plain_cell_forward', 'fused_cell', ('_launch',)),
    ('plain_convs', 'grouped_conv',
     ('_launch_forward', '_launch_dx', '_launch_dw')),
    ('plain_ctc', 'ctc_pallas', ('_launch_alpha', '_launch_beta'))])
def test_plain_switches_swap_and_restore(switch, module, names):
    """Each witness switch puts the plain versions in the wrappers' place
    inside, and puts the kernels back after, also when the body raises."""
    import importlib
    from nbasr_torch.ops import plain
    mod = importlib.import_module(f'nbasr_torch.ops.{module}')
    before = [getattr(mod, n) for n in names]
    with pytest.raises(RuntimeError):
        with getattr(plain, switch)():
            inside = [getattr(mod, n) for n in names]
            raise RuntimeError
    assert all(a is not b for a, b in zip(inside, before))
    assert [getattr(mod, n) for n in names] == before
