"""The port's NAS query and search layer against the JAX package on the CPU:
the graph hash over the whole search space, sampling and the helpers, every
query of the committed ``db/`` folders, dataset files written by either
package, the searches' histories, the CLI and the facade."""

import json
import pathlib
import pickletools
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import nbasr_tpu
from nbasr_tpu import cli as jax_cli
from nbasr_tpu import dataset as jax_dataset
from nbasr_tpu import graph_utils as jax_graph_utils
from nbasr_tpu import search as jax_search
from nbasr_tpu import search_space as jax_search_space
from nbasr_tpu import utils as jax_utils

import nbasr_torch
from nbasr_torch import cli, dataset, graph_utils, search, search_space, utils

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
GOLDEN_HASH = '36855332a5778e0df5114305bc3ce238'
GOLDEN_ARGV = ['1', '0', '1', '0', '0', '1', '0', '0', '0']
# the committed folders: (folder, max_epochs)
FOLDERS = (('db', 2), ('db/e40', 40), ('db/e40', 5))


def test_golden_hash():
    assert search_space.get_model_hash(GOLDEN_ARCH) == GOLDEN_HASH


def test_every_hash_equals_jax():
    archs = list(search_space.get_all_architectures())
    assert archs == list(jax_search_space.get_all_architectures())
    assert len(archs) == 13824
    hashes = [search_space.get_model_hash(a) for a in archs]
    assert hashes == [jax_search_space.get_model_hash(a) for a in archs]
    assert len(set(hashes)) == 8242
    assert len({h for a, h in zip(archs, hashes)
                if 5 not in utils.flatten(a)}) == 8000


@pytest.mark.parametrize('minimize', [True, False])
def test_graphs_equal_jax(minimize):
    for arch in search_space.get_random_architectures(200, seed=11):
        (mat, labels), orig = graph_utils.get_model_graph(arch,
                                                          minimize=minimize)
        (jmat, jlabels), jorig = jax_graph_utils.get_model_graph(
            arch, minimize=minimize)
        np.testing.assert_array_equal(mat, jmat)
        assert labels == jlabels
        assert (orig is None) == (jorig is None)
        assert graph_utils.to_dot((mat, labels)) == \
            jax_graph_utils.to_dot((jmat, jlabels))


@pytest.mark.parametrize('seed', [None, 0, 1, 7, 1234])
def test_random_architectures_equal_jax(seed):
    if seed is None:        # the module-level generator, seeded alike
        random.seed(5)
        got = search_space.get_random_architectures(40)
        random.seed(5)
        want = jax_search_space.get_random_architectures(40)
    else:
        got = search_space.get_random_architectures(40, seed=seed)
        want = jax_search_space.get_random_architectures(40, seed=seed)
    assert got == want


def test_search_space_constants_and_zero_archs_equal_jax():
    for name in ('ALL_OPS', 'OPS_NO_ZERO', 'DEFAULT_NODES', 'all_ops',
                 'ops_no_zero', 'default_nodes'):
        assert getattr(search_space, name) == getattr(jax_search_space, name)
    assert search_space.get_search_space() == \
        jax_search_space.get_search_space()
    assert search_space.get_search_space(ops=['a', 'b'], nodes=2) == \
        jax_search_space.get_search_space(ops=['a', 'b'], nodes=2)
    zero = search_space.get_archs_with_zero()
    assert zero == jax_search_space.get_archs_with_zero()
    assert len(zero) == 242
    assert search_space.arch_vec_to_names(GOLDEN_ARCH) == \
        jax_search_space.arch_vec_to_names(GOLDEN_ARCH)


@pytest.mark.parametrize('seq', [
    [[1, 0], [1, 0, 0], [1, 0, 0, 0]], [], [[], [[]]], [1, [2, [3, [4]]]],
    ('a', ['bc', ('d',)]), [np.int64(3), [2.5]]])
def test_utils_equal_jax(seq):
    assert list(utils.recursive_iter(seq)) == \
        list(jax_utils.recursive_iter(seq))
    flat = utils.flatten(seq)
    assert flat == jax_utils.flatten(seq)
    assert utils.copy_structure(flat, seq) == \
        jax_utils.copy_structure(flat, seq) == seq
    assert utils.count(iter(flat)) == jax_utils.count(iter(flat))
    n = len(flat) // 2
    assert list(utils.get_first_n(flat, n)) == \
        list(jax_utils.get_first_n(flat, n))
    for num in (0, 7, 26338848, -1234567, 3.9):
        assert utils.make_nice_number(num) == jax_utils.make_nice_number(num)


def _pair(folder, max_epochs):
    kw = dict(max_epochs=max_epochs, include_static_info=True)
    return (dataset.from_folder(ROOT / folder, **kw),
            jax_dataset.from_folder(ROOT / folder, **kw))


@pytest.mark.parametrize('folder,max_epochs', FOLDERS)
def test_every_query_equals_jax(folder, max_epochs):
    d, jd = _pair(folder, max_epochs)
    assert (d.seeds, d.epochs, d.version, d.columns, d.ops, d.nodes,
            d.search_space) == (jd.seeds, jd.epochs, jd.version, jd.columns,
                                jd.ops, jd.nodes, jd.search_space)
    assert d.bench_info.devices == jd.bench_info.devices
    archs = [row[-1] for row in d.dbs[0].values()]
    assert archs and (folder != 'db' or GOLDEN_ARCH in archs)
    archs += [[[5, 1], [5, 1, 1], [5, 1, 1, 1]]]       # not in any file
    for arch in archs:
        assert (arch in d) == (arch in jd)
        for seed in d.seeds:
            for return_dict in (True, False):
                for devices in (None, False):
                    assert d.full_info(arch, seed=seed, devices=devices,
                                       return_dict=return_dict) == \
                        jd.full_info(arch, seed=seed, devices=devices,
                                     return_dict=return_dict)
            assert d.test_acc(arch, seed=seed) == jd.test_acc(arch, seed=seed)
            for epoch in (None, 1, max_epochs // 2):
                for best in (True, False):
                    assert d.val_acc(arch, epoch=epoch, best=best,
                                     seed=seed) == \
                        jd.val_acc(arch, epoch=epoch, best=best, seed=seed)
        random.seed(3)
        got = d.full_info(arch)                 # a seed drawn by `random`
        random.seed(3)
        assert got == jd.full_info(arch)
        for return_dict in (True, False):
            assert d.latency(arch, return_dict=return_dict) == \
                jd.latency(arch, return_dict=return_dict)
        assert d.params(arch) == jd.params(arch)
        assert d.flops(arch) == jd.flops(arch)
        graph, _ = graph_utils.get_model_graph(arch)
        assert d.full_info_by_graph(graph, seed=d.seeds[0]) == \
            jd.full_info_by_graph(graph, seed=d.seeds[0])


def test_flagship_query_is_finite():
    d = dataset.from_folder(ROOT / 'db', max_epochs=2)
    info = d.full_info(GOLDEN_ARCH, seed=1235)
    assert info['model_hash'] == GOLDEN_HASH
    assert all(np.isfinite(info['val_per'])) and np.isfinite(info['test_per'])


def _opcodes(path):
    with open(path, 'rb') as f:
        data = f.read()
    ops, pos = set(), 0
    while pos < len(data):          # two pickles, one after the other
        for op, _, end in pickletools.genops(data[pos:]):
            ops.add(op.name)
        pos += end + 1
    return ops


def _rows(arch_count=5):
    archs = search_space.get_random_architectures(arch_count, seed=2)
    return archs, [[search_space.get_model_hash(a),
                    [float(0.9 - 0.01 * e) for e in range(3)],
                    float(0.85), a] for a in archs]


@pytest.mark.parametrize('writer', ['torch', 'jax'])
def test_written_files_cross_between_packages(tmp_path, writer):
    archs, rows = _rows()
    mods = {'torch': dataset, 'jax': jax_dataset}
    w = mods[writer]
    for seed in (1, 2):
        w.write_db(tmp_path / f'nb-asr-e3-{seed}.pickle',
                   w.make_header('training', epochs=3, seed=seed), rows)
    w.write_db(tmp_path / 'nb-asr-bench-h100.pickle',
               w.make_header('benchmarking', device='h100'),
               [[r[0], float(0.01 * i)] for i, r in enumerate(rows)])
    w.write_db(tmp_path / 'nb-asr-info.pickle',
               w.make_header('static', version=2),
               [[r[0], int(1000 + i), int(5000 + i)]
                for i, r in enumerate(rows)])
    for path in tmp_path.iterdir():
        # builtins only: no class is looked up when the file is read
        assert not _opcodes(path) & {'GLOBAL', 'STACK_GLOBAL', 'REDUCE',
                                     'INST', 'OBJ', 'NEWOBJ'}, path
    kw = dict(max_epochs=3, include_static_info=True)
    d = dataset.from_folder(tmp_path, **kw)
    jd = jax_dataset.from_folder(tmp_path, **kw)
    assert d.header == jd.header and d.dbs == jd.dbs
    for arch in archs:
        for seed in (1, 2):
            assert d.full_info(arch, seed=seed) == \
                jd.full_info(arch, seed=seed)


def test_committed_files_hold_builtins_only():
    for path in sorted((ROOT / 'db').rglob('*.pickle')):
        assert not _opcodes(path) & {'GLOBAL', 'STACK_GLOBAL'}, path


def test_reader_checks_equal_jax(tmp_path):
    archs, rows = _rows()
    dataset.write_db(tmp_path / 'nb-asr-e3-1.pickle',
                     dataset.make_header('training', epochs=3, seed=1), rows)
    dataset.write_db(tmp_path / 'nb-asr-e3-2.pickle',
                     dataset.make_header('training', epochs=3, seed=2),
                     rows[:-1])
    for mod in (dataset, jax_dataset):
        with pytest.raises(ValueError, match='has 4 entries'):
            mod.from_folder(tmp_path, max_epochs=3)
        with pytest.raises(ValueError, match='benchmarking information'):
            mod.BenchmarkingDataset([tmp_path / 'nb-asr-e3-1.pickle'])
        with pytest.raises(ValueError, match='not a directory'):
            mod.from_folder(tmp_path / 'missing')
        assert mod.from_folder(tmp_path, max_epochs=3, seeds=1).seeds == [1]


def _fields(result):
    return result.best_arch, result.best_score, result.history


@pytest.mark.parametrize('seed', [0, 3, 1234])
def test_searches_over_the_dataset_equal_jax(seed):
    d, jd = _pair('db/e40', 40)
    ev = search.dataset_evaluator(d, seed=1235)
    jev = jax_search.dataset_evaluator(jd, seed=1235)
    got = search.random_search(ev, iterations=40, seed=seed)
    want = jax_search.random_search(jev, iterations=40, seed=seed)
    assert _fields(got) == _fields(want)
    assert np.isfinite(got.best_score)          # some arch was in the file
    got = search.regularized_evolution(ev, iterations=60, population_size=10,
                                       sample_size=3, seed=seed)
    want = jax_search.regularized_evolution(jev, iterations=60,
                                            population_size=10, sample_size=3,
                                            seed=seed)
    assert _fields(got) == _fields(want) and got.num_evaluations == 60
    assert [got.best_at(k) for k in (1, 10, 60)] == \
        [want.best_at(k) for k in (1, 10, 60)]
    # the evaluator answers a db/e40 arch and +inf elsewhere, as JAX's
    known = next(iter(d.dbs[0].values()))[-1]
    assert ev(known) == jev(known) <= 1.0
    assert ev(GOLDEN_ARCH) == jev(GOLDEN_ARCH) == float('inf')


def test_mutation_equals_jax():
    rng, jrng = random.Random(9), random.Random(9)
    arch = jarch = GOLDEN_ARCH
    for _ in range(50):
        arch, jarch = search._mutate(arch, rng), jax_search._mutate(jarch,
                                                                    jrng)
        assert arch == jarch


@pytest.mark.parametrize('argv', [
    ['hash'] + GOLDEN_ARGV,
    ['hash', '5', '1', '0', '1', '1', '2', '0', '1', '1'],
    ['query', str(ROOT / 'db'), *GOLDEN_ARGV, '--seed', '1235',
     '--max_epochs', '2'],
    ['query', str(ROOT / 'db/e40'), '1', '0', '1', '0', '0', '0', '0', '0',
     '0', '--seed', '1236'],
    ['query', str(ROOT / 'db/e40'), *GOLDEN_ARGV, '--seed', '1234']],
    ids=['hash', 'hash-zero', 'query-db', 'query-e40', 'query-missing'])
def test_cli_prints_what_jax_prints(argv, capsys):
    cli.main(argv)
    got = capsys.readouterr().out
    jax_cli.main(argv)
    assert got == capsys.readouterr().out
    if argv[0] == 'query':
        json.loads(got)


def test_cli_viz_writes_what_jax_writes(tmp_path, capsys):
    arch = ['5', '1', '1', '0', '1', '2', '0', '1', '1']   # minimal != full
    cli.main(['viz', *arch, '--out', str(tmp_path / 'torch')])
    got = capsys.readouterr().out.split()
    jax_cli.main(['viz', *arch, '--out', str(tmp_path / 'jax')])
    want = capsys.readouterr().out.split()
    assert [pathlib.Path(p).name for p in got] == \
        [pathlib.Path(p).name for p in want]
    assert len(got) == 2
    for p, q in zip(got, want):
        assert pathlib.Path(p).read_text() == pathlib.Path(q).read_text()


@pytest.mark.parametrize('cmd', [
    ['sweep', '--archs', '2'], ['info'], ['benchpass'],
    ['quantize', 'best.ckpt']], ids=lambda c: c[0])
def test_cli_later_commands_are_refused(cmd, tmp_path, monkeypatch):
    if cmd[0] == 'quantize':     # ported now: it goes to read the checkpoint
        monkeypatch.chdir(tmp_path)
        with pytest.raises(FileNotFoundError, match='best.ckpt'):
            cli.main(cmd)
        return
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        cli.main(cmd)


def test_facade():
    for name in ('search_space', 'graph_utils', 'search', 'from_folder',
                 'Dataset', 'BenchmarkingDataset', 'StaticInfoDataset',
                 'get_model', 'get_dataloaders', 'get_loss', 'get_trainer',
                 'set_seed', 'prepare_devices', 'set_default_backend',
                 'get_backend_name', '__version__'):
        assert hasattr(nbasr_torch, name), name
        assert hasattr(nbasr_tpu, name), name
    assert nbasr_torch.get_backend_name() == ('torch', 'torch')
    assert nbasr_torch.set_default_backend() == ('torch', 'torch')
    with pytest.raises(ValueError):
        nbasr_torch.set_default_backend('jax')
    d = nbasr_torch.from_folder(ROOT / 'db', max_epochs=2)
    assert isinstance(d, nbasr_torch.Dataset)
    from nbasr_torch import version
    assert version.__version__ == nbasr_torch.__version__
    assert version.has_repo in (True, False)
    model = nbasr_torch.get_model(
        GOLDEN_ARCH, device='cpu', block_kernels=(4,), block_strides=(1,),
        block_filters=(16,), cells_per_block=(1,), cell_groups=4,
        rnn_units=8)
    assert sum(p.numel() for p in model.parameters()) > 0
    loaders = nbasr_torch.get_dataloaders('synthetic:4', batch_size=2,
                                          curriculum=())
    assert len(loaders) == 4
    trainer = nbasr_torch.get_trainer(loaders, nbasr_torch.get_loss(),
                                      device='cpu', verbose=False)
    assert trainer.device == torch.device('cpu')


def test_set_seed_and_prepare_devices(monkeypatch):
    g = nbasr_torch.set_seed(17)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    g = nbasr_torch.set_seed(17)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item(),
                 torch.rand(1, generator=g).item())
    assert nbasr_torch.prepare_devices('cpu') == [torch.device('cpu')]
    assert nbasr_torch.prepare_devices(['cpu']) == [torch.device('cpu')]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for devices in (None, 0, [0], 'cuda'):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            nbasr_torch.prepare_devices(devices)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert nbasr_torch.prepare_devices() == [torch.device('cuda', 0)]
    assert nbasr_torch.prepare_devices(0) == [torch.device('cuda', 0)]
    with pytest.raises(ValueError, match='out of range'):
        nbasr_torch.prepare_devices([1])


def test_queries_work_without_jax():
    """The query path on a machine without JAX: the package's modules
    refuse to import, and hashing and querying still answer."""
    code = (
        'import sys\n'
        'for m in ("jax", "flax", "nbasr_tpu"): sys.modules[m] = None\n'
        'import nbasr_torch as n\n'
        'print(n.search_space.get_model_hash([[1,0],[1,0,0],[1,0,0,0]]))\n'
        'd = n.from_folder("db/e40")\n'
        'print(d.test_acc([[1,0],[1,0,0],[0,0,0,0]], seed=1234))\n'
        'import nbasr_torch.cli, nbasr_torch.models.proxies\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    lines = out.stdout.split()
    assert lines[0] == GOLDEN_HASH
    want = jax_dataset.from_folder(ROOT / 'db/e40').test_acc(
        [[1, 0], [1, 0, 0], [0, 0, 0, 0]], seed=1234)
    assert float(lines[1]) == want
