"""Shared fixtures of the benchmark's tests: a reduced width at which the
CPU runs the cells end to end, and the ``card`` marker of tests that need
a CUDA card (they decide inside the ``card`` fixture, and skip here)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the cells' configurations cut to a width the CPU runs in seconds
SMALL = {'block_filters': [16, 16, 16, 16], 'cells_per_block': [1, 1, 1, 1],
         'cell_groups': 4, 'rnn_units': 8}
#: the mixes cut alike; training in f32, where the program's plain
#: versions agree with the reference to rounding
MIXES = {'train': {'utterances': 24, 'batch_size': 4, 'bucket_caps': [4, 3],
                   'compute_dtype': 'float32', 'trace_steps': 2},
         'serve': {'streams': 4, 'sentences_per_stream': 2, 'groups': 4,
                   'bank_s': 60, 'warmup_stream_s': 3, 'trace_calls': 3,
                   'sample_streams': 8}}


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'card: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the chip: python -m pytest '
                    'perfbench/tests -m card)')
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def overrides(kind):
    return {'config': SMALL, 'mix': MIXES[kind]}
