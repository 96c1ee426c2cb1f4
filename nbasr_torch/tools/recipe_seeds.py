"""How the tone-corpus recipe's 40-epoch outcome depends on the init draw,
through the kernels and through their plain versions.

``quant_per_check``'s training from each seed, on the card once through
the kernels and once with every cell (training and no-grad forward) and
CTC recursion in its plain PyTorch version (:mod:`nbasr_torch.ops.plain`),
with cuDNN's deterministic algorithms so that a seed's run repeats bit
for bit (the first seed's kernel run is made twice to show it).  Each
run is judged by the JAX test's three asserts (best val LER < 0.5, the
test eval on the best weights < 0.6, epoch 1 > 0.6); per route the runs
that pass, the median and mean best val LER, and between the routes a
two-sided rank-sum test of the best val LERs.

Before the runs, one step's gradients on the recipe's first batch at seed
0's init: kernels against plain versions, each route against
itself under ``--nudges`` 1e-7 audio nudges, the plain versions on the
card against the CPU's, each as a share of a tensor's max; and each
cell backward on its own tensors against the plain version and both
against a float64 reference (``_cells_on_real_inputs``).

    python -m nbasr_torch.tools.recipe_seeds [--seeds 16] [--first 0]
        [--nudges 3] [--device cpu] [--json]

On the CPU (``--device cpu``) there is one route, the plain versions.
"""

import argparse
import contextlib
import json

import numpy as np
import torch

from ..ops import fused_cell
from ..ops.plain import plain_cell_forward, plain_cells, plain_ctc
from . import quant_per_check

__all__ = ['BEST_LER', 'TEST_LER', 'FIRST_LER', 'deterministic', 'plain',
           'nudged', 'step_gradients', 'shares', 'step_witness', 'passes',
           'routes_summary', 'main']

#: the JAX test's asserts (``tests/test_per_recipe.py``)
BEST_LER, TEST_LER, FIRST_LER = 0.5, 0.6, 0.6
NUDGE = 1e-7


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms (the block convs' backward may
    otherwise add partial sums in a racy order)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def plain():
    """Every cell and CTC recursion in its plain version."""
    with plain_cells(), plain_cell_forward(), plain_ctc():
        yield


def nudged(batch, k):
    """``batch`` with its audio scaled by 1 + 1e-7 x a normal draw (the
    ``k``-th)."""
    audio = batch['audio']
    noise = np.random.RandomState(k).randn(*audio.shape)
    return dict(batch, audio=(audio * (1 + NUDGE * noise)).astype(np.float32))


def step_gradients(trainer, model, batch):
    """One step's gradients before clipping at the model's weights, on the
    CPU: ``{name: tensor}``."""
    trainer.init_state(model, seed=0)
    grads, _ = trainer.gradients(batch)
    return {n: g.cpu() for n, g in grads.items()}


def shares(got, want):
    """{tensor: max |got - want| / max |want|}."""
    out = {}
    for n, w in want.items():
        if not bool(torch.isfinite(got[n]).all()):
            raise FloatingPointError(f'{n}: non-finite gradient')
        out[n] = float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                       1e-30)
    return out


def _worst_over(runs):
    return {n: max(r[n] for r in runs) for n in runs[0]}


@contextlib.contextmanager
def _in_float64():
    """The plain versions' f32 casts made f64: a float64 reference."""
    saved = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = saved


def _share(got, want, mask=None):
    """max |got - want| / max |want|, over ``mask``'s elements if given."""
    d, ref = (got.double() - want.double()).abs(), want.double().abs()
    if mask is not None:
        d, ref = d[mask], ref[mask]
    return float(d.max()) / max(float(ref.max()), 1e-300)


@contextlib.contextmanager
def _cells_on_real_inputs(out):
    """Holds each cell backward of a step, on the step's own tensors (its
    input, saved node outputs and multipliers, and dy), against the plain
    versions and both against a float64 plain backward.  Appends per cell:
    the node outputs recomputed from x and the multipliers that differ;
    dx, dW/db and dscale/dbias against the plain versions, each as its
    worst share of a tensor's max; the kernel's and the plain version's
    dx and dW against float64, dx over the frames whose LayerNorm input
    is not constant ('live': the utterances, not the padding past them,
    whose rows are constant and whose gradients LayerNorm scales by
    1/sqrt(eps)); the padded share of the frames and max |dx| over the
    live frames' max."""
    saved = fused_cell.fused_cell_backward

    def recorded(spec, x, outs, mults, dy, weights, ln):
        got = saved(spec, x, outs, mults, dy, weights, ln)
        _, w_outs, w_mults = fused_cell.fused_cell_reference(
            spec, x, weights, ln, None, save=True)
        plain = fused_cell.fused_cell_backward_reference(
            spec, x, outs, mults, dy, weights, ln)
        with _in_float64():
            exact = fused_cell.fused_cell_backward_reference(
                spec, x.double(), outs.double(), mults.double(), dy.double(),
                [w.double() for w in weights],
                ln and [t.double() for t in ln])
        rows = outs[-1].float().var(dim=-1) > 0
        live = rows[..., None].expand_as(x)
        against = lambda r, ref: dict(
            dx_live=_share(r[0], ref[0], live),
            dweights=max(_share(a, b) for a, b in zip(r[1], ref[1])))
        out.append(dict(
            outs=_share(outs, w_outs), mult_flips=int((mults != w_mults).sum()),
            dx=_share(got[0], plain[0]),
            dweights=max(_share(a, b) for a, b in zip(got[1], plain[1])),
            dln=max((_share(a, b) for a, b in zip(got[2] or (), plain[2] or ())),
                    default=0.0),
            kernel_vs_f64=against(got, exact), plain_vs_f64=against(plain, exact),
            padded=float((~rows).float().mean()),
            dx_max_over_live=float(exact[0].abs().max())
            / max(float(exact[0].abs()[live].max()), 1e-300)))
        return got

    fused_cell.fused_cell_backward = recorded
    try:
        yield
    finally:
        fused_cell.fused_cell_backward = saved


def step_witness(device, seed=0, nudges=3, fault=None):
    """One step's gradients on the recipe's first train batch at seed
    ``seed``'s init, cuDNN deterministic.  Returns ``{pair: {tensor:
    share}}`` for 'kernels vs plain', 'cell kernels vs plain' (the CTC
    plain on both sides), 'ctc kernels vs plain' (the cells plain on both
    sides), 'kernels nudged' and 'plain nudged' (the worst of ``nudges``
    1e-7 audio nudges against the same route unnudged; 'each nudge' the
    kernels' worst share under each), 'plain vs cpu'
    (on the card), 'fault vs plain' when ``fault`` (a context manager
    factory) is given; and 'cells' (:func:`_cells_on_real_inputs`,
    backward order)."""
    loaders, trainer, model = quant_per_check.build(device, seed)
    batch = next(iter(loaders[1]))
    cells = []
    with deterministic():
        kernels = step_gradients(trainer, model, batch)
        with _cells_on_real_inputs(cells):
            step_gradients(trainer, model, batch)
        k_nudged = [step_gradients(trainer, model, nudged(batch, k))
                    for k in range(nudges)]
        with plain_ctc():
            cell_kernels = step_gradients(trainer, model, batch)
        with plain_cells():
            ctc_kernels = step_gradients(trainer, model, batch)
        with plain():
            ref = step_gradients(trainer, model, batch)
            p_nudged = [step_gradients(trainer, model, nudged(batch, k))
                        for k in range(nudges)]
        out = {'kernels vs plain': shares(kernels, ref),
               'cell kernels vs plain': shares(cell_kernels, ref),
               'ctc kernels vs plain': shares(ctc_kernels, ref),
               'kernels nudged': _worst_over([shares(g, kernels)
                                              for g in k_nudged]),
               'each nudge': [max(shares(g, kernels).values())
                              for g in k_nudged],
               'plain nudged': _worst_over([shares(g, ref)
                                            for g in p_nudged])}
        if fault is not None:
            with fault():
                out['fault vs plain'] = shares(
                    step_gradients(trainer, model, batch), ref)
    if torch.device(device).type != 'cpu':
        _, host, cpu_model = quant_per_check.build('cpu', seed)
        out['plain vs cpu'] = shares(ref, step_gradients(host, cpu_model,
                                                         batch))
    out['cells'] = cells
    return out


def passes(run):
    """Whether one run passes the JAX test's three asserts."""
    return (run['best'] < BEST_LER and run['test']['val_ler'] < TEST_LER
            and run['val_ler'][0] > FIRST_LER)


def routes_summary(runs):
    """Per route (``{route: [run, ...]}``): runs, passing runs, median and
    mean best val LER, median test LER, least epoch-1 LER; and with two
    routes the two-sided rank-sum p of their best val LERs."""
    out = {}
    for route, rs in runs.items():
        best = [r['best'] for r in rs]
        out[route] = dict(
            runs=len(rs), passing=sum(passes(r) for r in rs),
            median_best=float(np.median(best)), mean_best=float(np.mean(best)),
            median_test=float(np.median([r['test']['val_ler'] for r in rs])),
            least_first=float(min(r['val_ler'][0] for r in rs)))
    if len(runs) == 2:
        from scipy.stats import mannwhitneyu
        a, b = ([r['best'] for r in rs] for rs in runs.values())
        out['rank_sum_p'] = float(mannwhitneyu(a, b,
                                               alternative='two-sided').pvalue)
    return out


def _print_witness(w):
    for pair, s in w.items():
        if pair == 'cells':
            for i, c in enumerate(s):
                print(f'one step, cell call {i} (backward order) on its real '
                      f'inputs, kernels against plain, shares: {c}')
            continue
        if pair == 'each nudge':
            print('one step, kernels nudged, worst share of each nudge:',
                  ', '.join(f'{v:.2e}' for v in s))
            continue
        worst = sorted(s.items(), key=lambda kv: -kv[1])[:3]
        print(f'one step, {pair}, worst shares of a tensor\'s max: '
              + ', '.join(f'{n} {v:.3e}' for n, v in worst))
    if 'kernels nudged' in w:
        ratio = {n: v / max(w['kernels nudged'][n], 1e-30)
                 for n, v in w['kernels vs plain'].items()}
        worst = max(ratio, key=ratio.get)
        print(f'one step, kernels vs plain over kernels nudged: worst '
              f'{ratio[worst]:.3f} ({worst}: {w["kernels vs plain"][worst]:.3e}'
              f' against {w["kernels nudged"][worst]:.3e})')


def main(argv=None):
    p = argparse.ArgumentParser(prog='python -m nbasr_torch.tools.'
                                'recipe_seeds')
    p.add_argument('--seeds', type=int, default=16,
                   help='this many seeds, from --first on')
    p.add_argument('--first', type=int, default=0)
    p.add_argument('--nudges', type=int, default=3)
    p.add_argument('--epochs', type=int, default=quant_per_check.EPOCHS)
    p.add_argument('--device', default='cuda')
    p.add_argument('--json', action='store_true')
    args = p.parse_args(argv)
    card = torch.device(args.device).type == 'cuda'
    if card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    witness = step_witness(args.device, nudges=args.nudges)
    _print_witness(witness)
    routes = ('kernels', 'plain') if card else ('cpu',)
    runs = {r: [] for r in routes}
    repeat = None
    with deterministic():
        for seed in range(args.first, args.first + args.seeds):
            for route in routes:
                _, trainer, model = quant_per_check.build(args.device, seed)
                with plain() if route == 'plain' else contextlib.nullcontext():
                    run = quant_per_check.train(trainer, model,
                                                epochs=args.epochs)
                run = dict(seed=seed, best=run['best'],
                           best_epoch=run['best_epoch'],
                           val_ler=run['val_ler'], test=run['test'],
                           seconds=run['seconds'])
                runs[route].append(run)
                print(f'seed {seed} {route}: best {run["best"]:.3f} at epoch '
                      f'{run["best_epoch"]}, test {run["test"]["val_ler"]:.3f},'
                      f' epoch 1 {run["val_ler"][0]:.3f}, '
                      f'{"passes" if passes(run) else "fails"}; '
                      f'{run["seconds"]:.1f} s; curve '
                      f'{[round(v, 2) for v in run["val_ler"]]}', flush=True)
                if seed == args.first and route == routes[0]:
                    _, trainer, model = quant_per_check.build(args.device,
                                                              seed)
                    again = quant_per_check.train(trainer, model,
                                                  epochs=args.epochs)
                    repeat = again['val_ler'] == run['val_ler']
                    print(f'seed {seed} {route} again: the same curve: '
                          f'{repeat}')
    summary = routes_summary(runs)
    for route, s in summary.items():
        print(f'{route}: {s}')
    out = dict(witness=witness, runs=runs, summary=summary, repeats=repeat)
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
