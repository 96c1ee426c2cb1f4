"""The forward kernel's launch plans against their cost estimates, on one card.

    python3 -m nbasr_torch.tools.fwd_sweep [--fused] [--top N] [--out FILE]

From the root of a checkout.  At the flagship's four conv5 widths (bf16,
B=32, 100 groups, K=5) on the dense layout without the epilogue and on a
contiguous split tensor with it, takes the N cheapest plans of
``grouped_conv.fwd_candidates`` (the card's SMs and occupancy calculator)
and as many more spread over the rest, plus the plan that
:func:`fill_one_wave` picks, runs each through
``nbasr_grouped_conv_forward``, checks its output against the plain
version within ``chip_smoke.TOL`` and times it with
``chip_smoke.device_ms`` (device time per call of calls queued behind a
spin kernel).  Prints one line per width and layout with the plan
``fwd_plan`` picks, its rank by time, the fill-one-wave plan and the
fastest plan; ``--out`` writes every measured plan as JSON lines.

With ``--fused`` it sweeps the fused cell forward's conv node instead
(``nbasr_fused_cell_forward`` on a cell of one conv5 node, the plans of
``fwd_candidates`` with the f32 output tile and the register tiles that
``fused_cell.forward_plans`` uses): at the train step's widths (bf16,
B=32) the training forward (dropout 0.2, multipliers kept) and the
serving forward, at the serving window's widths (B=4) the serving forward
in f32 and bf16; each checked against ``fused_cell_reference`` (node
output within ``chip_smoke.TOL``, the dropped elements' multipliers 0).
"""

import argparse
import ctypes
import functools
import json

import torch

import chip_smoke
from nbasr_torch.ops import _build, fused_cell, grouped_conv

B, K = 32, 5
KEYS = ('gs', 'rows', 'span', 'cc', 'threads', 'grid', 'blocks_per_sm',
        'x_vec', 'y_vec')


def fill_one_wave(cands, G, sms):
    """The plan the dW's rule (``grouped_conv.dw_plan``) would pick among
    ``cands``: per slab size the largest weight chunk and the longest time
    tile the block allows, and the fewest units a block that keep the grid
    within one wave of resident blocks; then the slab that fills the wave
    best (to the nearest quarter), pads the fewest groups (a tenth more
    where a staged vector is under 8 bytes), and is largest."""
    best = {}
    for _, p in cands:
        slots = sms * p['blocks_per_sm']
        key = (p['cc'], p['rows'], p['grid'] <= slots, -p['span']
               if p['grid'] <= slots else p['span'])
        if p['gs'] not in best or key > best[p['gs']][0]:
            best[p['gs']] = key, p

    def rank(p):
        fill = min(1.0, p['grid'] / (sms * p['blocks_per_sm']))
        padded = -(-G // p['gs']) * p['gs'] + (
            G // 10 if min(p['x_vec'], p['y_vec']) < 8 else 0)
        return -int(4 * fill + 0.5), padded, -p['gs']

    return min((p for _, p in best.values()), key=rank)


def pick_plans(cands, chosen, wave, top):
    """The ``top`` cheapest of ``cands`` (cost, plan) pairs, as many more
    spread over the rest, and the chosen and fill-one-wave plans."""
    rest = cands[top:]
    pick = [p for _, p in cands[:top] + rest[::max(1, len(rest) // top)]]
    return pick + [p for p in (chosen, wave) if p not in pick]


def report(label, measured):
    """One line: the chosen plan's time and rank, fill-one-wave's, the
    fastest's."""
    measured.sort(key=lambda r: r['ms'])
    rank = next(i for i, r in enumerate(measured) if r['chosen'])
    mine = measured[rank]
    other = next(r for r in measured if r['fill_one_wave'])
    best = measured[0]
    print(f'{label}: fwd_plan {mine["ms"]:.4f} ms '
          f'(rank {rank + 1} of {len(measured)}) '
          f'{ {k: mine[k] for k in KEYS} }; fill-one-wave '
          f'{other["ms"]:.4f} ms { {k: other[k] for k in KEYS} }; '
          f'fastest {best["ms"]:.4f} ms '
          f'{ {k: best[k] for k in KEYS} }', flush=True)


def sweep_fused(top):
    """The fused forward's conv node at the four train widths (training
    and serving forward) and the four serving widths (serving forward, f32
    and bf16): its plans' device times.  Returns the rows."""
    _build.build(('fused_cell',))
    dev = torch.device('cuda')
    fn = _build.function('fused_cell', 'nbasr_fused_cell_forward',
                         fused_cell._FWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = grouped_conv._sm_count(dev)
    G = chip_smoke.GROUPS
    seed = torch.tensor(chip_smoke.TRAIN_SEED, dtype=torch.int32, device=dev)
    lines = []
    cases = ([(B, C, T, torch.bfloat16, (True, False))
              for C, T in chip_smoke.TRAIN_WIDTHS]
             + [(chip_smoke.B, C, T, dtype, (False,))
                for dtype in (torch.float32, torch.bfloat16)
                for C, T in chip_smoke.WIDTHS])
    for Bn, C, T, dtype, modes in cases:
        ci = C // G
        esize = torch.finfo(dtype).bits // 8
        lpad, rpad = chip_smoke.conv_padding(K, 1, 1)
        g = torch.Generator().manual_seed(C)
        x = torch.randn((Bn, T, C), generator=g).to(dev, dtype)
        w = (torch.randn((K, ci, C), generator=g) / (K * ci) ** 0.5).to(
            dev, dtype)
        b = (0.1 * torch.randn((C,), generator=g)).to(dev)
        node = fused_cell.ConvNode(K, 1, lpad, rpad, G, ci, ci, ())
        st = (T * C, 1, C, ci)
        shape = (Bn, T, G, ci, ci, K, 1, esize, st, st, 0, 0)
        kw = dict(sms=sms, blocks_per_sm=functools.partial(
            grouped_conv._blocks_per_sm, dev, 'fused_cell',
            'nbasr_fused_conv_fwd_blocks_per_sm', int(esize == 2)),
            y_esize=4, reg_tiles=fused_cell.F32_TILES if esize == 4 else None)
        chosen = fused_cell.forward_plans(
            (0, K, 1, lpad, ci, ci, 0), Bn, T, C, esize, (0,), (0,),
            sms, kw['blocks_per_sm'])[0]
        cands = sorted(grouped_conv.fwd_candidates(*shape, **kw),
                       key=lambda c: c[0])
        wave = fill_one_wave(cands, G, sms)
        for train in modes:
            spec = fused_cell.FusedCellSpec(
                [node], dropout_rate=chip_smoke.DROPOUT if train else 0.0,
                train=train, use_norm=False)
            want = fused_cell.fused_cell_reference(spec, x, [w, b], None,
                                                   seed, save=True)
            y = torch.empty_like(x)
            mults = torch.empty_like(x)
            measured = []
            for plan in pick_plans(cands, chosen, wave, top):
                desc = (ctypes.c_int * fused_cell.FWD_DESC_INTS)(
                    0, K, 1, lpad, ci, ci, 0,
                    *(plan[k] for k in grouped_conv.FWD_PLAN_FIELDS))
                call = lambda: _build.check(fn(
                    int(esize == 2), Bn, T, C, 1, desc, (ctypes.c_void_p * 1)(w.data_ptr()),
                    (ctypes.c_void_p * 1)(b.data_ptr()), x.data_ptr(), None,
                    y.data_ptr(), None, None, 0, 0.0,
                    seed.data_ptr() if train else None,
                    fused_cell.keep_threshold(chip_smoke.DROPOUT),
                    fused_cell.inv_keep(chip_smoke.DROPOUT),
                    mults.data_ptr() if train else None, stream),
                    'fused_cell', 'fused cell forward')
                call()
                scale = float(want[0].float().abs().max())
                err = float((y.float() - want[0].float()).abs().max())
                assert err <= chip_smoke.TOL[dtype] * scale, (
                    C, train, plan, err, scale)
                if train:
                    assert torch.equal(mults == 0, want[2][0] == 0), (C, plan)
                row = dict(B=Bn, C=C, T=T, dtype=str(dtype)[6:], train=train,
                           ms=chip_smoke.device_ms(call),
                           chosen=plan == chosen, fill_one_wave=plan == wave,
                           **{k: plan[k] for k in grouped_conv.FWD_PLAN_FIELDS
                              + ('grid', 'blocks_per_sm')})
                measured.append(row)
                lines.append(row)
            report(f'fused B={Bn} C={C} T={T} {str(dtype)[6:]} '
                   f'{"train" if train else "serve"}', measured)
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--fused', action='store_true')
    parser.add_argument('--top', type=int, default=12)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    if args.fused:
        lines = sweep_fused(args.top)
        if args.out:
            with open(args.out, 'w') as f:
                for row in lines:
                    f.write(json.dumps(row) + '\n')
        return
    _build.build(('grouped_conv',))
    dev = torch.device('cuda')
    fn = _build.function('grouped_conv', 'nbasr_grouped_conv_forward',
                         grouped_conv._FWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = grouped_conv._sm_count(dev)
    occupancy = functools.partial(grouped_conv._blocks_per_sm, dev,
                                  'grouped_conv',
                                  'nbasr_grouped_conv_fwd_blocks_per_sm', 1)
    G = chip_smoke.GROUPS
    lines = []
    with torch.no_grad():
        for C, T in chip_smoke.TRAIN_WIDTHS:
            ci = C // G
            x, dz, w, b = chip_smoke._gconv_operands(
                C, T, B, K, 1, torch.bfloat16, dev,
                torch.Generator().manual_seed(C))
            for layout in chip_smoke.GCONV_LAYOUTS:
                xs, _, y, _ = chip_smoke._gconv_args(x, dz, layout)
                bias = b if layout == 'split' else None
                want = grouped_conv.conv_forward_reference(
                    xs, w, bias, 2, 1, torch.empty_like(y)).float()
                scale = float(want.abs().max())
                shape = (B, T, G, ci, ci, K, 1, 2, xs.stride(), y.stride(),
                         xs.data_ptr() % 16, y.data_ptr() % 16)
                chosen = grouped_conv.fwd_plan(*shape, sms=sms,
                                               blocks_per_sm=occupancy)
                cands = sorted(grouped_conv.fwd_candidates(
                    *shape, sms=sms, blocks_per_sm=occupancy),
                    key=lambda c: c[0])
                wave = fill_one_wave(cands, G, sms)
                measured = []
                for plan in pick_plans(cands, chosen, wave, args.top):
                    ints = (ctypes.c_int * len(grouped_conv.FWD_PLAN_FIELDS))(
                        *(plan[k] for k in grouped_conv.FWD_PLAN_FIELDS))
                    call = lambda: _build.check(fn(
                        1, B, T, G, ci, ci, K, 1, 2, xs.data_ptr(),
                        grouped_conv._strides(xs), w.data_ptr(),
                        None if bias is None else bias.data_ptr(),
                        y.data_ptr(), grouped_conv._strides(y), ints, stream),
                        'grouped_conv', 'grouped conv forward')
                    y.zero_()
                    call()
                    err = float((y.float() - want).abs().max())
                    assert err <= chip_smoke.TOL[torch.bfloat16] * scale, (
                        C, layout, plan, err, scale)
                    row = dict(C=C, T=T, layout=layout,
                               ms=chip_smoke.device_ms(call),
                               chosen=plan == chosen, fill_one_wave=plan == wave,
                               **{k: plan[k] for k in
                                  grouped_conv.FWD_PLAN_FIELDS + (
                                      'grid', 'blocks_per_sm')})
                    measured.append(row)
                    lines.append(row)
                report(f'C={C} T={T} {layout}', measured)
    if args.out:
        with open(args.out, 'w') as f:
            for row in lines:
                f.write(json.dumps(row) + '\n')


if __name__ == '__main__':
    main()
