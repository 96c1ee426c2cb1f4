"""Mixes of kind ``train``: a closed loop of ``Trainer.step`` calls, back to
back, over the port's ``Loader`` on a deck made from the seed.

Set-up builds one trainer (the model through its architecture's
``build``, the run's weights, Adam), drives it through its first steps,
which the reference follows (:func:`checked_steps`: ``CHECK_STEPS``, or
more until every bucket shape has run), and on until every bucket shape
has run twice.  The window then steps until ``--seconds`` have passed;
it ends in a synchronize.  With ``--trace 1`` the window's first half is
an unprofiled stretch (``mfu.train``); steps run on to the end of the
Loader's epoch, then one whole epoch runs under the profiler on the
device alone (every epoch runs the same batch shapes, so its counts hold
from seed to seed), and ``trace_steps`` more steps with the host and the
benchmark's spans.
"""

import gc

import numpy as np
import torch

from .. import archs, traffic, trace
from ..common import (DTYPES, build_model, by_parts, now, profiled_pace,
                      syncer)
from ..reference import batches as ref_batches
from ..reference import frontend as ref_fe
from ..reference import model as ref
from ..weights import generate

CHECK_STEPS = 3
MAX_CHECK_STEPS = 8
FRAME_S = 0.010


def loader_seed(seed):
    """The Loader's shuffle seed: the run's, below 2**31."""
    return int(seed) % 2 ** 31


def checked_steps(shapes, kinds):
    """How many of the first steps, whose batch shapes are ``shapes`` in
    order, the reference follows: ``CHECK_STEPS``, or more until ``kinds``
    shapes (the mix's buckets) have run, at most ``MAX_CHECK_STEPS``;
    ``None`` while ``shapes`` is too short to say."""
    for n in range(1, len(shapes) + 1):
        if n >= MAX_CHECK_STEPS or (
                n >= CHECK_STEPS and len(set(shapes[:n])) >= kinds):
            return n
    return None


def _launch_counters():
    from nbasr_torch.ops import ctc_pallas, fused_cell
    return [fused_cell.LAUNCHES, fused_cell.BACKWARD_LAUNCHES,
            *ctc_pallas.LAUNCHES.values()]


def _reset_launches():
    from nbasr_torch.ops import ctc_pallas, fused_cell
    fused_cell.reset_launches()
    ctc_pallas.reset_launches()


def _loss_pair(trainer):
    num, den = trainer.metrics['ctc_loss']
    return float(num), float(den)


class _Stream:
    """The Loader's batches, epoch after epoch, with how many are left in
    the current epoch."""

    def __init__(self, loader):
        self.per_epoch, self.taken = len(loader), 0
        self._batches = self._epochs(loader)

    @staticmethod
    def _epochs(loader):
        while True:
            yield from loader

    def __iter__(self):
        return self

    def __next__(self):
        self.taken += 1
        return next(self._batches)

    def left_in_epoch(self):
        return -self.taken % self.per_epoch


def setup(cfg, mix, seed, device):
    """The trainer, its batch stream and the deck."""
    from nbasr_torch.data.phonemes import PhonemeEncoder
    from nbasr_torch.data.pipeline import ArrayDataset, Loader
    from nbasr_torch.training import Trainer
    audio, labels = traffic.deck(mix, seed)
    loader = Loader(ArrayDataset(audio, labels, name='deck'),
                    mix['batch_size'],
                    bucket_boundaries=(mix['bucket_boundary'],),
                    bucket_batch_caps=tuple(mix['bucket_caps']),
                    shuffle=True, seed=loader_seed(seed))
    model, w0 = build_model(cfg, mix, seed, device)
    trainer = Trainer((PhonemeEncoder(48), loader, None, None), device=device,
                      verbose=False, eval_decoder='greedy',
                      clip_norm=mix['clip'], tensorboard=False)
    trainer.init_state(model, seed=seed)
    return trainer, _Stream(loader), (audio, labels), w0


def program_readings(trainer, it, w0, lr, kinds):
    """The first steps through ``Trainer.step`` (:func:`checked_steps`):
    each step's mean normalised CTC, each leaf's norm of the first
    gradient as Adam got it (its first moment after one step over ``1 -
    beta1``), each leaf's norm of its change over the steps, the first
    step's logits (read by a hook on the model, removed after that step)
    and its gradients (kept on the host).  Returns them, as
    :func:`perfbench.reference.model.follow_train` does, and the shapes
    run."""
    losses, first, shapes, logits = [], None, [], []
    beta1 = trainer.optimizer.param_groups[0]['betas'][0]
    hook = trainer.model.register_forward_hook(
        lambda m, a, out: logits.append(out.detach().float().clone()))
    while checked_steps(shapes, kinds) is None:
        b = next(it)
        n0, d0 = _loss_pair(trainer)
        trainer.step(b, training=True, lr=lr)
        n1, d1 = _loss_pair(trainer)
        losses.append((n1 - n0) / max(d1 - d0, 1.0))
        shapes.append(tuple(b['audio'].shape))
        if len(shapes) == 1:
            hook.remove()
            state = trainer.optimizer.state
            first = {n: float(state[p]['exp_avg'].norm()) / (1 - beta1)
                     if p in state else 0.0
                     for n, p in trainer.model.named_parameters()}
            grads = {n: (state[p]['exp_avg'] / (1 - beta1)).cpu()
                     if p in state else torch.zeros(p.shape)
                     for n, p in trainer.model.named_parameters()}
    with torch.no_grad():
        change = {n: float((p - w0[n]).norm())
                  for n, p in trainer.model.named_parameters()}
    return {'loss': losses, 'first': first, 'change': change,
            'logits': logits[0].cpu(), 'grads': grads,
            'shapes': shapes}, shapes


def _leaf_gaps(prog, ref_, keys):
    med = float(np.median([ref_[k] for k in keys]))
    return [abs(prog[k] - ref_[k]) / max(ref_[k], med, 1e-30) for k in keys]


def _logit_gap(pl, rl, llen):
    """The widest gap of ``pl`` from ``rl`` over ``rl``'s largest, on the
    valid frames."""
    if pl.shape != rl.shape:
        return float('inf')
    valid = (torch.arange(rl.shape[1], device=rl.device)[None, :]
             < llen.to(rl.device)[:, None])[..., None]
    diff = torch.where(valid, (pl.to(rl.device) - rl).abs(), 0.0)
    return float(diff.max() / torch.where(valid, rl.abs(), 0.0).max())


def compare(prog, refr):
    """The numbers a cell may compare (its limits file says which): the
    worst step's relative loss gap; the worst leaf's and the median leaf's
    first-gradient gap of norms; the worst leaf's gap of the change over
    the steps (over leaves whose reference gradient is at least a
    thousandth of the median leaf's); the widest gap of the first step's
    logits over the reference's largest, on the valid frames; the median
    leaf's norm of the first gradients' difference over the reference's
    norm; and, for the record, how many leaves ``change`` left out.
    Where the two sides ran other batch shapes, the loss and logit gaps
    are infinite."""
    rf = refr['first']
    keys = sorted(rf)
    med = float(np.median([rf[k] for k in keys]))
    moving = [k for k in keys if rf[k] >= 1e-3 * med]
    grad = _leaf_gaps(prog['first'], rf, keys)
    change = _leaf_gaps(prog['change'], refr['change'], moving)
    loss = logit = float('inf')
    if prog['shapes'] == refr['shapes']:
        loss = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog['loss'], refr['loss']))
        logit = _logit_gap(prog['logits'], refr['logits'],
                           refr['logit_len'])
    diff = [float((prog['grads'][k].to(g.device) - g).norm()
                  / max(float(g.norm()), 1e-30))
            for k, g in refr['grads'].items()]
    return {'loss': loss, 'grad': max(grad),
            'grad_median': float(np.median(grad)), 'change': max(change),
            'logit': logit,
            'grad_diff': float(np.median(diff)) if diff else float('inf'),
            'left_out': len(keys) - len(moving)}


def reference_readings(cfg, mix, seed, device, deck, rnd=ref.identity):
    """The reference's readings of the same steps, from the same weights
    and deck, batched by its own copy of the recipe's batching."""
    audio, labels = deck
    bs, epoch, n = [], 0, None
    while n is None:
        bs += ref_batches.batches(audio, labels, loader_seed(seed), epoch,
                                  mix['bucket_boundary'],
                                  tuple(mix['bucket_caps']))
        epoch += 1
        shapes = [b['audio'].shape for b in bs]
        n = checked_steps(shapes, len(mix['bucket_caps']))
    bs, shapes = bs[:n], shapes[:n]
    w0 = generate(cfg, seed, device)
    out = ref.follow_train(archs.find(cfg), cfg, mix, ref.load_stats(), w0,
                           bs, seed, device, rnd=rnd)
    out['shapes'] = shapes
    return out


def _profiled(trainer, it, name, sync, lr, span_steps):
    """A whole epoch under the profiler on the device alone, then
    ``span_steps`` steps with the host and the benchmark's spans; the two
    traces, the epoch's steps and the second stretch's cell calls'
    shapes."""
    epoch = it.per_epoch
    with trace.profile(name, sync, spans=False) as dev:
        for _ in range(epoch):
            trainer.step(next(it), training=True, lr=lr)
    model = trainer.model
    calls, cells_undo = trace.hook_cells(model)
    undo = [cells_undo, trace.hook_modules([model], 'forward'),
            trace.wrap_methods(trainer, {'_put_batch': 'h2d',
                                         '_loss_and_grads': 'backward',
                                         '_objective': 'loss',
                                         '_update': 'norm_read'}),
            trace.wrap_methods(trainer.optimizer, {'step': 'optimizer'})]
    with trace.profile(name, sync, spans=True) as prof:
        for _ in range(span_steps):
            with trace.span('loader'):
                b = next(it)
            with trace.span('step'):
                trainer.step(b, training=True, lr=lr)
    for u in undo:
        u()
    return dev.trace, prof.trace, epoch, calls


def run(cell, cfg, mix, seed, seconds, traced, device, t0):
    """One run of a ``train`` cell: set-up, the window, and what the
    result and the comparison need (``perfbench.run`` reads it)."""
    sync = syncer(device)
    arch = archs.find(cfg)
    lr = mix['lr']
    kinds = len(mix['bucket_caps'])
    trainer, it, deck, w0 = setup(cfg, mix, seed, device)
    prog, shapes = program_readings(trainer, it, w0, lr, kinds)
    del w0
    seen = {s: shapes.count(s) for s in shapes}
    for _ in range(mix['max_warmup_steps']):
        if len(seen) >= kinds and min(seen.values()) >= 2:
            break
        b = next(it)
        trainer.step(b, training=True, lr=lr)
        shape = tuple(b['audio'].shape)
        seen[shape] = seen.get(shape, 0) + 1
    sync()
    setup_s = now() - t0
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    bad0 = trainer.nonfinite_steps
    esize = DTYPES[mix['compute_dtype']].itemsize
    out = {'metrics': {}, 'layer': {'cfg': cfg, 'esize': esize}}
    steps, audio_s, fl, marks = 0, 0.0, 0.0, []
    span = seconds / 2 if traced else seconds
    start = now()
    while True:
        b = next(it)
        trainer.step(b, training=True, lr=lr)
        steps += 1
        audio_s += float(b['feature_size'][b['valid'] > 0].sum()) * FRAME_S
        rows, samples = b['audio'].shape
        fl += arch.algorithmic_flops(cfg, rows, ref_fe.num_frames(samples))
        marks.append((now(), audio_s))
        if now() - start >= span:
            break
    sync()
    elapsed = now() - start
    attempted = steps
    note = (f'{steps} timed steps, {audio_s:.3f} audio-s, {elapsed:.3f} s; '
            f'audio-s/s by fifths of the window: '
            f'{by_parts(marks, start, start + elapsed)}')
    if traced:
        out['layer'].update(stretch_flops=fl, stretch_seconds=elapsed)
        to_end = it.left_in_epoch()
        for _ in range(to_end):
            trainer.step(next(it), training=True, lr=lr)
        k = mix['trace_steps']
        dev, spans, epoch, calls = _profiled(trainer, it, cell['name'], sync,
                                             lr, k)
        out['layer'].update(device=dev, steps=epoch, spans=spans,
                            cell_calls=calls)
        attempted += to_end + epoch + k
        note += '; ' + profiled_pace(elapsed / steps, dev.window_seconds()
                                     / epoch, spans.window_seconds() / k)
    else:
        out['metrics']['train_audio_s_per_s'] = audio_s / elapsed
    failed = trainer.nonfinite_steps - bad0
    out['plain_launches'] = (sum(c['plain'] for c in _launch_counters())
                             if device.type == 'cuda' else None)
    out['memory_peak'] = (torch.cuda.max_memory_allocated(device)
                          if device.type == 'cuda' else 0)
    out.update(setup_s=setup_s, attempted=attempted, failed=failed,
               print=note)
    del trainer, it, b
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    out['check'] = lambda rnd=ref.identity: compare(
        prog, reference_readings(cfg, mix, seed, device, deck, rnd))
    return out
