"""Readings that set a cell's limits: the program's numbers over many
seeds, the control's (the reference in the precision below the
configuration's, put in the program's place), each planted fault's
(:mod:`perfbench.faults`) and, for training, a witness's (the reference
rounded at the configuration's own precision: what rounding alone
reads), at the cell's own size, in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 12 --first <n>
        [--control 3] [--faults 3] [--witness 0] [--out <file>]

Training cells need no window: set-up's first steps are compared.  A
serving cell serves its first group of streams (the longest, 60 s, takes
every chunk shape) and compares as many streams as a run does.  Each
reading prints as one JSON line.  The benchmark's own runs do not run
this.
"""

import argparse
import contextlib
import gc
import json
import sys

import torch

from . import archs, faults, run
from .common import syncer
from .drivers import serve as serve_driver
from .drivers import train as train_driver
from .reference import model as ref

__all__ = ['readings', 'main']


def _free(device):
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def _train(cfg, mix, seed, device, what):
    """One training seed's numbers for ``what``: 'program', 'control',
    'witness' (the reference rounded at the configuration's own precision)
    or a fault's name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if what in ('control', 'witness'):
        trainer, it, deck, w0 = train_driver.setup(cfg, mix, seed, device)
        del trainer, it, w0
        _free(device)
        low = train_driver.reference_readings(
            cfg, mix, seed, device, deck, rnd=ref.rounding(
                mix['control'] if what == 'control'
                else mix['compute_dtype']))
    else:
        ctx = (faults.planted('train', what) if what != 'program'
               else contextlib.nullcontext())
        with ctx:
            trainer, it, deck, w0 = train_driver.setup(cfg, mix, seed, device)
            low, _ = train_driver.program_readings(
                trainer, it, w0, mix['lr'], len(mix['bucket_caps']))
        del trainer, it, w0
        _free(device)
    return train_driver.compare(low, train_driver.reference_readings(
        cfg, mix, seed, device, deck))


def _serve(cfg, mix, seed, device, what):
    import numpy as np
    from . import traffic
    from .common import build_model
    model, _ = build_model(cfg, mix, seed, device)
    model.eval()
    piece = int(round(mix['piece_s'] * traffic.SAMPLE_RATE))
    lengths = traffic.stream_lengths(mix, seed)
    bank = traffic.bank(mix, seed)
    offsets = traffic.stream_offsets(mix, seed, lengths, len(bank))
    order = np.argsort(-lengths.max(axis=1))
    g = serve_driver._Group(lengths[order[0]], offsets[order[0]], bank, piece)
    ctx = (faults.planted('serve', what)
           if what not in ('program', 'control') else contextlib.nullcontext())
    with ctx, torch.no_grad():
        kept, dec = serve_driver._serve_group(model, mix, g, device,
                                              serve_driver._Calls())
    syncer(device)()
    del model
    _free(device)
    tp = serve_driver._padded_frames(cfg, mix, g)
    pick = traffic.rng(seed, 5)
    rows = list(dict.fromkeys(
        [int(np.argmax(g.lengths))] +
        [int(r) for r in pick.permutation(len(g.lengths))]))
    rows = rows[:mix['sample_streams']]
    sample = [(g, r, serve_driver._rows(kept, r), list(dec.tokens[r]), tp)
              for r in rows]
    ts = archs.find(cfg).output_stride(cfg)
    rnd = ref.rounding(mix['control']) if what == 'control' else ref.identity
    return serve_driver.compare(cfg, seed, device, sample, ts, rnd)


def readings(name, seed, device, what='program', overrides=None):
    """The numbers a cell compares, for one seed and one of 'program',
    'control' or a fault's name."""
    _, cfg, mix, *_ = run.cell_spec(name)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get('config', {})}
    mix = {**mix, **overrides.get('mix', {})}
    fn = _train if mix['kind'] == 'train' else _serve
    return fn(cfg, mix, seed, device, what)


def main(argv=None):
    p = argparse.ArgumentParser(prog='python3 -m perfbench.calibrate')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, default=12)
    p.add_argument('--first', type=int, default=1)
    p.add_argument('--control', type=int, default=3)
    p.add_argument('--faults', type=int, default=3)
    p.add_argument('--witness', type=int, default=0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    from nbasr_torch.ops import _build
    _build.build()
    device = torch.device('cuda', 0)
    kind = run.cell_spec(args.workload)[2]['kind']
    plan = [('program', args.seeds), ('control', args.control),
            ('witness', args.witness if kind == 'train' else 0)] + [
        (f, args.faults) for f in faults.FAULTS[kind]]
    out = open(args.out, 'a') if args.out else None
    for what, n in plan:
        for s in range(args.first, args.first + n):
            seed = 1_000_003 * s + 2 ** 31
            line = json.dumps({'workload': args.workload, 'what': what,
                               'seed': seed, 'numbers': readings(
                                   args.workload, seed, device, what)})
            print(line, flush=True)
            if out:
                out.write(line + '\n')
                out.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
