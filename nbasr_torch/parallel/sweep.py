"""Sweep orchestrator of the port: regenerate NAS-Bench-ASR's dataset on
the card, the counterpart of ``nbasr_tpu/parallel/sweep.py``.

  - :func:`unique_architectures`: one representative arch per graph hash,
    the JAX package's hashes in its order;
  - :func:`run_sweep`: (arch x seed) jobs over device groups, one worker
    thread per group; a group of one device trains with the plain
    :class:`~nbasr_torch.training.Trainer`, a larger one data-parallel in
    one spawned process per device
    (:class:`~nbasr_torch.parallel.ParallelTrainer`); per-epoch validation
    PER curves and the test PER go to ``nb-asr-e{E}-{seed}.pickle`` in the
    reference format (read by both packages' ``from_folder``), with the
    JAX package's ``sweep-e{E}.jsonl`` resume log (the same JSON keys, so
    either package resumes the other's log);
  - :func:`static_info_pass`: ``[hash, params, flops]`` rows of
    ``nb-asr-info.pickle``.  ``flops`` is the port's algorithmic count
    (``models.asr.algorithmic_flops``, forward, B=1), which equals the JAX
    package's ``algorithmic_flops``; the JAX sweep writes XLA's cost
    analysis there instead, which has no PyTorch counterpart;
  - :func:`benchmark_pass`: the median latency of synchronised f32
    forwards at B=1, written as ``nb-asr-bench-<device>.pickle``.

Every pass runs on the card unless the caller names the CPU; nothing falls
back to the CPU or to a kernel's plain version.
"""

import contextlib
import json
import pathlib
import queue
import threading
import time

import numpy as np
import torch

from .. import dataset as ds
from ..search_space import get_all_architectures, get_model_hash
from ..utils import flatten

__all__ = ['unique_architectures', 'run_sweep', 'static_info_pass',
           'benchmark_pass', 'device_groups', 'device_key']


def unique_architectures(limit=None, ops=None, nodes=None):
    """One representative arch per unique graph hash (8,242 by default)."""
    seen = {}
    for arch in get_all_architectures(ops, nodes):
        h = get_model_hash(arch, ops=ops)
        if h not in seen:
            seen[h] = arch
            if limit is not None and len(seen) >= limit:
                break
    return seen  # {hash: arch}


def device_groups(devices=None, group_size=None):
    """Partition devices into equally sized scheduling groups.  ``devices``
    defaults to every visible card (none raises); names and indices are
    taken as ``torch.device``s."""
    from ..models.asr import resolve_device
    if devices is None:
        resolve_device('cuda')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(torch.device('cuda', d) if isinstance(d, int)
                              else d) for d in devices]
    group_size = group_size or len(devices)
    if len(devices) % group_size:
        raise ValueError(f'{len(devices)} devices not divisible by '
                         f'group_size={group_size}')
    return [devices[i:i + group_size]
            for i in range(0, len(devices), group_size)]


def _job_model(arch, seed, device, use_rnn, model_kwargs):
    from ..models.asr import get_model
    return get_model(arch, use_rnn=use_rnn, dropout_rate=0.2, data_norm=True,
                     device=device,
                     generator=torch.Generator().manual_seed(seed),
                     **(model_kwargs or {}))


def _fit(trainer, arch, seed, device, epochs, lr, use_rnn, model_kwargs):
    history, test_scores = trainer.train(
        _job_model(arch, seed, device, use_rnn, model_kwargs), epochs=epochs,
        lr=lr, seed=seed,
        model_name='_'.join(map(str, flatten(arch))) + f'_s{seed}')
    return history['val_ler'], test_scores['val_ler']


def _train_rank(rank, world, device, arch, seed, data_root, batch_size,
                epochs, lr, use_rnn, eval_decoder, save_dir, verbose,
                model_kwargs):
    """One rank of a data-parallel job (run by :func:`mesh.spawn`)."""
    from ..training import get_dataloaders, get_loss
    from .train_parallel import ParallelTrainer
    loaders = get_dataloaders(data_root, batch_size=batch_size,
                              num_shards=world, shard_index=rank)
    trainer = ParallelTrainer(loaders, get_loss(), device=device,
                              save_dir=save_dir, verbose=verbose,
                              eval_decoder=eval_decoder)
    return _fit(trainer, arch, seed, device, epochs, lr, use_rnn,
                model_kwargs)


def _train_one(arch, seed, data_root, batch_size, epochs, lr, devices,
               use_rnn, eval_decoder, save_dir, verbose, model_kwargs):
    """(validation PER curve, test PER) of one job on a device group."""
    from ..training import get_dataloaders, get_loss, get_trainer
    from .mesh import spawn
    args = (arch, seed, data_root, batch_size, epochs, lr, use_rnn,
            eval_decoder, save_dir, verbose, model_kwargs)
    if len(devices) > 1:
        return spawn(_train_rank, devices, args, timeout=SPAWN_TIMEOUT_S)[0]
    loaders = get_dataloaders(data_root, batch_size=batch_size)
    trainer = get_trainer(loaders, get_loss(), device=devices[0],
                          save_dir=save_dir, verbose=verbose,
                          eval_decoder=eval_decoder)
    return _fit(trainer, arch, seed, devices[0], epochs, lr, use_rnn,
                model_kwargs)


#: Seconds a data-parallel job's spawned processes may run (None: no
#: limit; tests set one so that a hung rank fails its test).
SPAWN_TIMEOUT_S = None


def run_sweep(archs, seeds=(1234, 1235, 1236), *, data_root='TIMIT',
              out_dir='nb-asr-db', batch_size=64, epochs=40, lr=1e-4,
              use_rnn=True, eval_decoder='beam', group_size=None,
              save_dir=None, verbose=False, progress=True, model_kwargs=None,
              workers=None, resume=True, devices=None):
    """Train ``archs`` x ``seeds`` and write reference-format training DBs.

    ``archs``: arch vectors, an int (the first N unique hashes), or None
    (all 8,242).  ``devices`` (default: every card) are cut into groups of
    ``group_size`` (default: one group of all); jobs run on one worker
    thread per group, and ``workers`` above the number of groups shares
    groups round-robin (on one card, one thread's host work overlaps the
    other's device work).  Completed jobs are appended to
    ``{out_dir}/sweep-e{epochs}.jsonl`` as they finish; a restarted sweep
    replays the finished (seed, hash) rows instead of retraining them.
    Returns the written paths."""
    if archs is None or isinstance(archs, int):
        archs = list(unique_architectures(limit=archs).values())
    groups = device_groups(devices, group_size=group_size)
    if workers is not None and workers > len(groups):
        groups = [groups[i % len(groups)] for i in range(workers)]

    jobs = [(seed, i, arch) for seed in seeds for i, arch in enumerate(archs)]
    per_seed_rows = {seed: [None] * len(archs) for seed in seeds}

    log_path = pathlib.Path(out_dir) / f'sweep-e{epochs}.jsonl'
    log_lock = threading.Lock()
    done = {}
    if resume and log_path.exists():
        with open(log_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue    # torn tail write from a killed run
                done[(rec['seed'], rec['hash'])] = rec
        if progress and done:
            print(f'[sweep] resume: {len(done)} finished jobs in {log_path}')

    def run_job(job, group):
        seed, i, arch = job
        h = get_model_hash(arch)
        cached = done.get((seed, h))
        if cached is not None:
            per_seed_rows[seed][i] = [h, cached['curve'], cached['test'],
                                      arch]
            return
        t0 = time.time()
        curve, test_per = _train_one(
            arch, seed, data_root, batch_size, epochs, lr, group, use_rnn,
            eval_decoder, save_dir, verbose, model_kwargs)
        row = [h, list(map(float, curve)), float(test_per), arch]
        per_seed_rows[seed][i] = row
        if resume:
            rec = json.dumps({'seed': seed, 'hash': h, 'curve': row[1],
                              'test': row[2]})
            with log_lock:
                log_path.parent.mkdir(parents=True, exist_ok=True)
                with open(log_path, 'a') as f:
                    f.write(rec + '\n')
        if progress:
            print(f'[sweep] seed {seed} arch {i + 1}/{len(archs)} '
                  f'hash {h[:8]} best_val {min(curve):.4f} '
                  f'test {test_per:.4f} ({time.time() - t0:.0f}s)')

    if len(groups) > 1:
        q = queue.Queue()
        for job in jobs:
            q.put(job)
        errors = []

        def worker(group):
            while not errors:
                try:
                    job = q.get_nowait()
                except queue.Empty:
                    return
                try:
                    run_job(job, group)
                except Exception as e:          # re-raised below
                    errors.append(e)

        threads = [threading.Thread(target=worker, args=(g,)) for g in groups]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    else:
        for job in jobs:
            run_job(job, groups[0])

    paths = []
    for seed, rows in per_seed_rows.items():
        header = ds.make_header('training', epochs=epochs, seed=seed)
        paths.append(ds.write_db(
            f'{out_dir}/nb-asr-e{epochs}-{seed}.pickle', header, rows))
    return paths


def static_info_pass(archs=None, out_dir='nb-asr-db', use_rnn=True,
                     feature_frames=500, model_kwargs=None, device='cuda'):
    """Write ``nb-asr-info.pickle``: ``[hash, params, flops]`` per arch,
    ``flops`` the algorithmic count of one B=1 forward over
    ``feature_frames`` frames (not XLA's cost analysis, as the JAX sweep's
    file holds)."""
    from ..models.asr import algorithmic_flops, count_params, get_model
    if archs is None or isinstance(archs, int):
        archs = list(unique_architectures(limit=archs).values())
    rows = []
    for arch in archs:
        model = get_model(arch, use_rnn=use_rnn, dropout_rate=0.0,
                          device=device, **(model_kwargs or {}))
        rows.append([get_model_hash(arch), int(count_params(model)),
                     int(algorithmic_flops(model, 1, feature_frames,
                                           train=False))])
    header = ds.make_header('static', version=2)
    return ds.write_db(f'{out_dir}/nb-asr-info.pickle', header, rows)


@contextlib.contextmanager
def _full_f32():
    """f32 convolutions and matmuls without TF32 (cuDNN's default)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def device_key(device):
    """The latency table's device name: the card's name lowercased, spaces
    to ``-``, plus ``-fp32`` (``cpu-fp32`` on the CPU)."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    return f"{name.lower().replace(' ', '-')}-fp32"


def benchmark_pass(archs=None, out_dir='nb-asr-db', device_name=None,
                   use_rnn=True, feature_frames=500, repeats=20,
                   device='cuda'):
    """Write ``nb-asr-bench-<device>.pickle``: per arch, the median
    host-clock seconds of ``repeats`` synchronised f32 (no TF32) forwards at
    B=1 over
    ``feature_frames`` frames, random-init weights, after one warm-up
    forward on the same input (it plans every cell shape that is timed)."""
    from ..models.asr import get_model, resolve_device
    device = resolve_device(device)
    if archs is None or isinstance(archs, int):
        archs = list(unique_architectures(limit=archs).values())
    if device_name is None:
        device_name = device_key(device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == 'cuda' else (lambda: None)
    feats = torch.as_tensor(np.random.RandomState(0).randn(
        1, feature_frames, 80).astype(np.float32), device=device)
    sizes = torch.as_tensor([feature_frames], dtype=torch.int32, device=device)
    rows = []
    for arch in archs:
        model = get_model(arch, use_rnn=use_rnn, dropout_rate=0.0,
                          device=device,
                          generator=torch.Generator().manual_seed(0)).eval()
        with torch.no_grad(), _full_f32():
            model(feats, sizes)
            sync()
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                model(feats, sizes)
                sync()
                times.append(time.perf_counter() - t0)
        rows.append([get_model_hash(arch), float(np.median(times))])
    header = ds.make_header('benchmarking', device=device_name)
    return ds.write_db(f'{out_dir}/nb-asr-bench-{device_name}.pickle',
                       header, rows)
