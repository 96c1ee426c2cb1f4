"""Subcommand CLI of the port: query / hash / sweep / static info / bench
pass / viz / proxies / quantize.

Counterpart of ``nbasr_tpu/cli.py``, with its parser:

    python -m nbasr_torch.cli query db/ 1 0 1 0 0 1 0 0 0 --seed 1235
    python -m nbasr_torch.cli hash 1 0 1 0 0 1 0 0 0
    python -m nbasr_torch.cli sweep --archs 4 --seeds 1234 \
        --data synthetic:32 --epochs 2 --out db/
    python -m nbasr_torch.cli info --archs 4 --out db/
    python -m nbasr_torch.cli benchpass --archs 4 --out db/
    python -m nbasr_torch.cli viz 1 0 1 0 0 1 0 0 0 --out graphs/
    python -m nbasr_torch.cli proxy synflow 1 0 1 0 0 1 0 0 0
    python -m nbasr_torch.cli quantize results/jax/<run>/best.ckpt

``sweep``, ``info``, ``benchpass`` and ``proxy`` run on the card
(``--device cuda``, the default: for ``sweep`` every visible card, in
groups of ``--group_size``) unless ``--device cpu`` is given.  ``info``'s
FLOPs column is the algorithmic count, not XLA's.  ``quantize`` reads a
checkpoint of either trainer (the JAX trainer's flax msgpack without flax),
int8-quantizes its parameters and writes the JAX package's
``<ckpt>.int8.npz``; it runs on the host.
"""

import argparse
import json


def _arch(ints):
    return [ints[0:2], ints[2:5], ints[5:9]]


def main(argv=None):
    parser = argparse.ArgumentParser(prog='nbasr_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)

    q = sub.add_parser('query', help='query a dataset folder for an arch')
    q.add_argument('folder')
    q.add_argument('model', type=int, nargs=9)
    q.add_argument('--seed', type=int, default=None)
    q.add_argument('--max_epochs', type=int, default=None)

    h = sub.add_parser('hash', help='print the graph hash of an arch')
    h.add_argument('model', type=int, nargs=9)

    s = sub.add_parser('sweep', help='train archs x seeds, write dataset files')
    s.add_argument('--archs', type=int, default=4)
    s.add_argument('--seeds', type=int, nargs='+', default=[1234, 1235, 1236])
    s.add_argument('--data', type=str, default='TIMIT')
    s.add_argument('--epochs', type=int, default=40)
    s.add_argument('--batch_size', type=int, default=64)
    s.add_argument('--lr', type=float, default=1e-4)
    s.add_argument('--out', type=str, default='nb-asr-db')
    s.add_argument('--group_size', type=int, default=None)
    s.add_argument('--decoder', type=str, default='beam')
    s.add_argument('--device', type=str, default='cuda')

    i = sub.add_parser('info', help='write params/FLOPs static-info file')
    i.add_argument('--archs', type=int, default=None)
    i.add_argument('--out', type=str, default='nb-asr-db')
    i.add_argument('--device', type=str, default='cuda')

    b = sub.add_parser('benchpass', help='measure latency per arch on this device')
    b.add_argument('--archs', type=int, default=None)
    b.add_argument('--out', type=str, default='nb-asr-db')
    b.add_argument('--device_name', type=str, default=None)
    b.add_argument('--device', type=str, default='cuda')

    v = sub.add_parser('viz', help='render an arch graph to DOT/PNG')
    v.add_argument('model', type=int, nargs=9)
    v.add_argument('--out', type=str, default='graphs')

    p = sub.add_parser('proxy', help='compute a zero-cost proxy for an arch')
    p.add_argument('name')
    p.add_argument('model', type=int, nargs=9)
    p.add_argument('--frames', type=int, default=128)
    p.add_argument('--device', type=str, default='cuda')

    z = sub.add_parser('quantize',
                       help='int8-PTQ a trainer checkpoint to one .npz')
    z.add_argument('ckpt', help='best.ckpt / latest.ckpt from a train run')
    z.add_argument('--out', type=str, default=None,
                   help='output .npz (default: <ckpt>.int8.npz)')

    args = parser.parse_args(argv)

    if args.cmd == 'hash':
        from .search_space import get_model_hash
        print(get_model_hash(_arch(args.model)))
    elif args.cmd == 'query':
        from .dataset import from_folder
        d = from_folder(args.folder, max_epochs=args.max_epochs)
        info = d.full_info(_arch(args.model), seed=args.seed)
        print(json.dumps(info, default=str, indent=2))
    elif args.cmd == 'sweep':
        from .parallel.sweep import run_sweep
        paths = run_sweep(args.archs, seeds=tuple(args.seeds),
                          data_root=args.data, out_dir=args.out,
                          batch_size=args.batch_size, epochs=args.epochs,
                          lr=args.lr, group_size=args.group_size,
                          eval_decoder=args.decoder,
                          devices=_sweep_devices(args.device))
        print('\n'.join(map(str, paths)))
    elif args.cmd == 'info':
        from .parallel.sweep import static_info_pass
        print(static_info_pass(args.archs, out_dir=args.out,
                               device=args.device))
    elif args.cmd == 'benchpass':
        from .parallel.sweep import benchmark_pass
        print(benchmark_pass(args.archs, out_dir=args.out,
                             device_name=args.device_name,
                             device=args.device))
    elif args.cmd == 'viz':
        from .graph_utils import show_model
        for path in show_model(_arch(args.model), out_dir=args.out):
            print(path)
    elif args.cmd == 'proxy':
        import numpy as np
        from .models.proxies import compute_proxy
        rng = np.random.RandomState(0)
        feats = rng.randn(1, args.frames, 80).astype('float32')
        fsize = np.asarray([args.frames], 'int32')
        labels = rng.randint(1, 49, size=(1, 8)).astype('int32')
        lsize = np.asarray([8], 'int32')
        print(compute_proxy(args.name, _arch(args.model), feats, fsize,
                            labels, lsize, device=args.device))
    elif args.cmd == 'quantize':
        from .quant import quantize_tree, quantized_size_bytes, save_quantized
        qtree = quantize_tree(_checkpoint_params(args.ckpt))
        out = args.out or args.ckpt + '.int8.npz'
        save_quantized(out, qtree)
        qb, fb = quantized_size_bytes(qtree)
        print(json.dumps({'out': out, 'int8_bytes': qb, 'f32_bytes': fb,
                          'ratio': round(qb / fb, 3)}))


def _sweep_devices(device):
    """``'cuda'``: every visible card (None); else the one device named."""
    return None if device == 'cuda' else [device]


def _checkpoint_params(path):
    """``{name: tensor}`` of a trainer checkpoint's parameters: the JAX
    trainer's (flax msgpack) or the port's (``torch.save``)."""
    import pathlib
    import torch
    from .checkpoint import is_flax_checkpoint, unpackb
    from .convert import from_flax, to_flax
    data = pathlib.Path(path).read_bytes()
    if is_flax_checkpoint(data[:1]):
        params = unpackb(data)['params']
    else:      # the frozen data-norm stats are no parameters
        params = to_flax(torch.load(path, map_location='cpu')['model'])[
            'params']
    return from_flax({'params': params})


if __name__ == '__main__':
    main()
