"""Queryable tabular NAS-Bench-ASR datasets (training / benchmarking / static).

Own copy of ``nbasr_tpu/dataset.py`` (the port imports nothing from the
JAX package), after the reference's ``nasbench_asr/dataset.py``, with its
**writer** API (:func:`write_db`) for dataset files in the exact on-disk
format the reference reads.

File format (reference ``dataset.py:28-67,477-486`` and README.md:19-38):
each ``.pickle`` file holds two sequential pickle objects —

1. ``header``: dict with ``dataset_type`` in {'training', 'benchmarking',
   'static'}, ``version``, ``columns``, ``search_space`` ({'shape', 'ops',
   'nodes'}), plus ``seed``+``epochs`` (training) or ``device``
   (benchmarking).
2. ``data``: list of rows ``[model_hash, *values]``.

Both hold Python builtins only (no torch tensor or numpy scalar), so that
the JAX package and the reference read the files the port writes: callers
of :func:`write_db` pass Python numbers.

File-name conventions (reference ``dataset.py:543-552``):
``nb-asr-e{epochs}-{seed}.pickle``, ``nb-asr-bench-{device}.pickle``,
``nb-asr-info.pickle``.
"""

import pickle
import random
import re
import pathlib
import functools
import collections.abc as cabc

from . import search_space
from . import graph_utils

__all__ = [
    'Dataset', 'BenchmarkingDataset', 'StaticInfoDataset', 'from_folder',
    'write_db', 'make_header',
]

_TRAINING_COLUMNS = ['model_hash', 'val_per', 'test_per']
_BENCH_COLUMNS = ['model_hash', 'latency']
_STATIC_COLUMNS_V1 = ['model_hash', 'params']
_STATIC_COLUMNS_V2 = ['model_hash', 'params', 'flops']


class _PickleDB:
    """Shared loader/validator for the three dataset flavours.

    Mirrors reference ``dataset.py:13-122``.
    """

    def __init__(self, dataset_files, validate_data, db_type):
        if isinstance(dataset_files, (str, pathlib.Path)):
            dataset_files = [dataset_files]
        if db_type == 'static' and len(dataset_files) != 1:
            raise ValueError('Expected exactly one dataset file')

        self.db_type = db_type
        self.dbs = []
        self.header = None
        self.seeds = [] if db_type == 'training' else None
        self.devices = [] if db_type == 'benchmarking' else None

        for db_file in dataset_files:
            with open(db_file, 'rb') as f:
                header = pickle.load(f)
                data = pickle.load(f)
            if header.get('dataset_type') != db_type:
                raise ValueError(f'Expected a dataset file with {db_type} information')

            if db_type == 'training':
                self.seeds.append(header.pop('seed'))
            elif db_type == 'benchmarking':
                self.devices.append(header.pop('device'))

            if self.header is None:
                self.header = header
            elif self.header != header:
                raise ValueError('Different dataset files contain data for different settings')

            self._check_columns(header)
            self.dbs.append({row[0]: list(row[1:]) for row in data})

        if not self.dbs:
            raise ValueError('At least one dataset should be read')

        if validate_data and len(self.dbs) > 1:
            self._cross_validate()

    def _check_columns(self, header):
        cols = header['columns']
        if self.db_type == 'training':
            expected = _TRAINING_COLUMNS
        elif self.db_type == 'benchmarking':
            expected = _BENCH_COLUMNS
        else:
            expected = _STATIC_COLUMNS_V1 if header['version'] < 2 else _STATIC_COLUMNS_V2
        if cols[:len(expected)] != expected:
            raise ValueError(
                f'Expected {self.db_type} dataset columns to start with {expected}, got {cols}')

    def _cross_validate(self):
        """Check that every file covers the same model set (reference dataset.py:72-84)."""
        reference_db = self.dbs[0]
        for fidx, db in enumerate(self.dbs[1:], start=1):
            if len(db) != len(reference_db):
                raise ValueError(
                    f'Dataset file at position {fidx} has {len(db)} entries '
                    f'but the one at position 0 has {len(reference_db)}')
            for model_hash, row in db.items():
                if model_hash not in reference_db:
                    raise ValueError(f'{model_hash} is present in dataset file {fidx} but not in 0')
                if self.db_type == 'training':
                    # last column is the arch vector; same hash => same arch
                    assert row[-1] == reference_db[model_hash][-1]

    # -- header accessors (reference dataset.py:86-118) --

    @property
    def version(self):
        return self.header['version']

    @property
    def search_space(self):
        return self.header['search_space']['shape']

    @property
    def ops(self):
        return self.header['search_space']['ops']

    @property
    def nodes(self):
        return self.header['search_space']['nodes']

    @property
    def columns(self):
        return self.header['columns']

    def __contains__(self, arch):
        return search_space.get_model_hash(arch, ops=self.ops) in self.dbs[0]


class StaticInfoDataset(_PickleDB):
    """Params/FLOPs per model (reference ``dataset.py:125-165``)."""

    def __init__(self, dataset_file):
        super().__init__([dataset_file], False, 'static')

    def _get(self, model_hash, return_dict):
        row = self.dbs[0].get(model_hash)
        if return_dict and row is not None:
            return dict(zip(self.columns[1:], row))
        return row

    def params(self, arch):
        """Number of parameters of ``arch`` (``None`` if unknown)."""
        row = self._get(search_space.get_model_hash(arch, ops=self.ops), False)
        return row[0] if row is not None else None

    def flops(self, arch):
        """Number of FLOPs of ``arch`` (file version >= 2 only)."""
        if self.version < 2:
            raise ValueError(
                f'FLOPS are only available in file version >= 2, current: {self.version}')
        row = self._get(search_space.get_model_hash(arch, ops=self.ops), False)
        return row[1] if row is not None else None


class BenchmarkingDataset(_PickleDB):
    """Measured per-device latency per model (reference ``dataset.py:168-240``)."""

    def __init__(self, dataset_files, validate_data=True):
        super().__init__(dataset_files, validate_data, 'benchmarking')

    def _get(self, model_hash, devices, return_dict):
        if devices is None:
            devices = self.devices
            indices = range(len(self.devices))
        else:
            if isinstance(devices, str):
                devices = [devices]
            indices = [self.devices.index(d) for d in devices]

        out = {} if return_dict else []
        for didx, device in zip(indices, devices):
            value = self.dbs[didx].get(model_hash)
            if value is None:
                return None
            if return_dict:
                out[device] = dict(zip(self.columns[1:], value))
            else:
                out.append(value)
        return out

    def latency(self, arch, devices=None, return_dict=False):
        """Latency rows for ``arch`` on the requested ``devices`` (all by default)."""
        model_hash = search_space.get_model_hash(arch, ops=self.ops)
        return self._get(model_hash, devices, return_dict)


class Dataset(_PickleDB):
    """Training curves keyed by arch hash, optionally joined with bench/static info.

    Mirrors reference ``dataset.py:243-474``: ``val_per`` rows are per-epoch
    curves, ``test_per`` is the test PER at the best-validation epoch.
    """

    def __init__(self, dataset_files, devices_files=None, static_info=None, validate_data=True):
        super().__init__(dataset_files, validate_data, 'training')
        self.bench_info = BenchmarkingDataset(devices_files, validate_data) if devices_files else None
        self.static_info = StaticInfoDataset(static_info) if static_info else None

    @property
    def epochs(self):
        return self.header['epochs']

    def _get_info(self, seed_idx, model_hash, return_dict):
        row = self.dbs[seed_idx].get(model_hash)
        if row is None:
            return None
        if return_dict:
            info = dict(zip(self.columns[1:], row))
            info[self.columns[0]] = model_hash
            info['seed'] = self.seeds[seed_idx]
            return info
        return [model_hash] + list(row) + [self.seeds[seed_idx]]

    def _query(self, model_hash, seed, devices, include_static_info, return_dict):
        seed_idx = (random.randrange(len(self.seeds)) if seed is None
                    else self.seeds.index(seed))
        ret = self._get_info(seed_idx, model_hash, return_dict)
        if ret is None:
            return None
        if devices is not False and (devices is not None or self.bench_info):
            if not self.bench_info:
                raise ValueError('No benchmarking information attached')
            lat = self.bench_info._get(model_hash, devices, return_dict)
            if lat is not None:
                if return_dict:
                    ret.update(lat)
                else:
                    ret.extend(lat)
        if include_static_info is None:
            include_static_info = self.static_info is not None
        if include_static_info:
            if not self.static_info:
                raise ValueError('No static information attached')
            info = self.static_info._get(model_hash, return_dict)
            if return_dict:
                ret['info'] = info
            else:
                ret.append(info)
        return ret

    def full_info(self, arch, seed=None, devices=None, include_static_info=None, return_dict=True):
        """All stored information about ``arch`` (random seed unless given)."""
        model_hash = search_space.get_model_hash(arch, ops=self.ops)
        return self._query(model_hash, seed, devices, include_static_info, return_dict)

    def full_info_by_graph(self, graph, seed=None, devices=None,
                           include_static_info=None, return_dict=True):
        """Same as :meth:`full_info` but keyed by a pre-built model graph."""
        model_hash = graph_utils.graph_hash(graph)
        return self._query(model_hash, seed, devices, include_static_info, return_dict)

    def test_acc(self, arch, seed=None):
        """Test PER at the epoch with best validation PER (reference dataset.py:402-420)."""
        info = self.full_info(arch, seed=seed, devices=False,
                              include_static_info=False, return_dict=False)
        return None if info is None else info[2]

    def val_acc(self, arch, epoch=None, best=True, seed=None):
        """Validation PER: best over the first ``epoch`` epochs, or at ``epoch``.

        Mirrors reference ``dataset.py:422-453``.
        """
        info = self.full_info(arch, seed=seed, devices=False,
                              include_static_info=False, return_dict=False)
        if info is None:
            return None
        curve = info[1]
        epoch = epoch if epoch is not None else len(curve)
        return min(curve[:epoch]) if best else curve[epoch - 1]

    @functools.wraps(BenchmarkingDataset.latency)
    def latency(self, *args, **kwargs):
        if not self.bench_info:
            raise ValueError('No benchmarking information attached')
        return self.bench_info.latency(*args, **kwargs)

    @functools.wraps(StaticInfoDataset.params)
    def params(self, *args, **kwargs):
        if not self.static_info:
            raise ValueError('No static information attached')
        return self.static_info.params(*args, **kwargs)

    @functools.wraps(StaticInfoDataset.flops)
    def flops(self, *args, **kwargs):
        if not self.static_info:
            raise ValueError('No static information attached')
        return self.static_info.flops(*args, **kwargs)


def from_folder(folder, max_epochs=None, seeds=None, devices=None,
                include_static_info=False, validate_data=True):
    """Discover dataset files in ``folder`` by name and build a :class:`Dataset`.

    Mirrors reference ``dataset.py:477-555`` (same filename regexes).
    """
    folder = pathlib.Path(folder).expanduser()
    if not folder.is_dir():
        raise ValueError(f'{folder} is not a directory')

    epochs_part = f'e{max_epochs if max_epochs is not None else 40}-'

    def to_pattern(values, default):
        if values is None:
            return default
        if isinstance(values, cabc.Sequence) and not isinstance(values, str):
            return '(' + '|'.join(map(str, values)) + ')'
        return str(values)

    seeds_pat = to_pattern(seeds, '[0-9]+')
    train_re = re.compile(f'nb-asr-{epochs_part}{seeds_pat}.pickle')
    bench_re = None
    if devices is not False:
        bench_re = re.compile(f'nb-asr-bench-{to_pattern(devices, "[a-zA-Z0-9-]+")}.pickle')

    datasets, bench_files, static_file = [], [], None
    for ff in folder.iterdir():
        if not ff.is_file():
            continue
        if train_re.fullmatch(ff.name):
            datasets.append(str(ff))
        if bench_re is not None and bench_re.fullmatch(ff.name):
            bench_files.append(str(ff))
        if include_static_info and ff.name == 'nb-asr-info.pickle':
            static_file = str(ff)

    return Dataset(sorted(datasets), sorted(bench_files), static_file,
                   validate_data=validate_data)


# ---------------------------------------------------------------------------
# Writer API (new in the TPU framework: used to regenerate dataset files)
# ---------------------------------------------------------------------------

def make_header(db_type, *, version=1, columns=None, ops=None, nodes=None,
                epochs=None, seed=None, device=None):
    """Build a dataset header dict compatible with the reference reader."""
    ops = ops if ops is not None else list(search_space.ALL_OPS)
    nodes = nodes if nodes is not None else search_space.DEFAULT_NODES
    if columns is None:
        if db_type == 'training':
            columns = _TRAINING_COLUMNS + ['arch_vec']
        elif db_type == 'benchmarking':
            columns = _BENCH_COLUMNS
        elif db_type == 'static':
            columns = _STATIC_COLUMNS_V1 if version < 2 else _STATIC_COLUMNS_V2
        else:
            raise ValueError(db_type)
    header = {
        'dataset_type': db_type,
        'version': version,
        'columns': columns,
        'search_space': {
            'shape': search_space.get_search_space(ops, nodes),
            'ops': ops,
            'nodes': nodes,
        },
    }
    if db_type == 'training':
        header['epochs'] = epochs
        header['seed'] = seed
    elif db_type == 'benchmarking':
        header['device'] = device
    return header


def write_db(path, header, rows):
    """Write a dataset pickle file: header object followed by the row list."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(header, f)
        pickle.dump(list(rows), f)
    return path
