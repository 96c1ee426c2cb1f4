"""Run one cell of the benchmark once and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
``BENCHMARK.json`` names the cell's configuration and traffic mix; the
configuration is ``perfbench/configs/<name>.json``, the mix
``perfbench/mixes/<traffic>.json``, whose ``kind`` picks the driver
(``perfbench/drivers/<kind>.py``), and the limits of the comparison with
the reference ``perfbench/limits/<cell>.json``.  With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by ``perfbench/metrics/<metric>.py`` from
the run's stretches: an unprofiled one, one profiled on the device alone
(busy and idle time, ``busy_s`` and ``window_s``, the breakdown's device
operations) and one profiled with the host's spans (attribution, the
breakdown's idle gaps).  The last line of standard output is the result, one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit.

A run without the cards it needs, or one that has loaded JAX, flax, optax
or the JAX package by the time its window closes, exits non-zero and
prints no result.
"""

import os
import time

T0 = time.perf_counter()
# one process, few threads: the host loops are what the cells time
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '1'

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'nbasr_tpu')

__all__ = ['main', 'run_cell', 'cell_spec', 'forbidden_modules',
           'FORBIDDEN']


def _json(path):
    return json.loads(pathlib.Path(path).read_text())


def cell_spec(name):
    """``(cell, config, mix, limits, end-to-end metrics, per-layer
    metrics)`` of the cell ``name`` of ``BENCHMARK.json``."""
    bench = _json(ROOT / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json '
                         f'(have {sorted(cells)})')
    cell = cells[name]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    cfg = _json(ROOT / conf['file'])
    mix = _json(HERE / 'mixes' / f"{cell['traffic']}.json")
    limits = _json(HERE / 'limits' / f'{name}.json')
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    layer = [m for m in bench['per_layer'] if name in m['workloads']]
    return cell, cfg, mix, limits, e2e, layer


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def _reader(metric):
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _merge(base, extra):
    return {**base, **(extra or {})}


def run_cell(name, seed, seconds, trace, device, overrides=None, t0=None):
    """One run of the cell on ``device`` (a ``torch.device``); returns the
    result object.  ``overrides`` (``{'config': {...}, 'mix': {...}}``)
    replaces entries of the cell's files: the CPU tests run the cells at a
    reduced width through it."""
    import torch
    cell, cfg, mix, limits, e2e, layer = cell_spec(name)
    overrides = overrides or {}
    cfg = _merge(cfg, overrides.get('config'))
    mix = _merge(mix, overrides.get('mix'))
    if device.type == 'cuda':
        from nbasr_torch.ops import _build
        _build.build()
    driver = importlib.import_module(f"perfbench.drivers.{mix['kind']}")
    out = driver.run(cell, cfg, mix, seed, seconds, bool(trace), device,
                     T0 if t0 is None else t0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f'loaded by the window\'s end: {found}')
    if mix['kind'] == 'train':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = out['check']()
    if out['plain_launches'] is not None:
        numbers['plain_launches'] = out['plain_launches']
        limits = {**limits, 'plain_launches': 0}
    checks = {k: {'value': numbers.get(k, float('nan')), 'limit': v}
              for k, v in limits.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())
    metrics = {}
    if trace:
        for m in layer:
            value = _reader(m['name'])(out['layer'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in e2e:
            value = (out['setup_s'] if m['name'] == 'setup_s'
                     else out['metrics'].get(m['name']))
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    on_card = device.type == 'cuda'
    dev = {'platform': 'gpu' if on_card else 'cpu',
           'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
           'count': cell['chips'], 'memory_peak_bytes': out['memory_peak']}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if trace:
        tr, spans = out['layer']['device'], out['layer']['spans']
        dev.update(busy_s=tr.busy(), window_s=tr.window_seconds())
        result['breakdown'] = {'device_ops': tr.device_ops(),
                               'idle_gaps': spans.idle_gaps()}
    result['checks'] = checks
    result['note'] = out['print']
    return result


def _card_line():
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().replace('\n', '; ')
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not readable'


def main(argv=None):
    parser = argparse.ArgumentParser(prog='python3 -m perfbench.run',
                                     description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cell_spec(args.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    import nbasr_torch  # noqa: F401  (a checkout without the port fails here)
    torch.set_num_threads(1)
    device = torch.device('cuda', 0)
    print(f'card: {_card_line()}', flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      device)
    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    note = result.pop('note')
    print(note, flush=True)
    print(json.dumps(result), flush=True)
    for k, c in result['checks'].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
