"""Train one NAS-Bench-ASR architecture with the port (the twin of the
repository's ``train.py``, same 9-int arch vector and flags).

    python -m nbasr_torch.train 1 0 1 0 0 1 0 0 0 --batch_size 64 \
        --epochs 40 --data TIMIT --lr 1e-4 --dropout 0.2 --seed 1235

``--data synthetic[:N]`` uses the built-in fake corpus.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the kernels' plain versions.
``--dtype`` defaults to bfloat16 on the card and float32 on the CPU.  Eval
decodes with the merged-prefix beam search, W=12, as ``train.py`` does
(``--decoder greedy`` for the greedy decoder).  The port writes its run to
``<exp_folder>/torch/<exp_name>``; where that folder has no checkpoint and
the JAX package's run of the same name (``<exp_folder>/jax/<exp_name>``)
left ``latest.ckpt``/``best.ckpt``, they are copied over and the run
resumes from them (``Trainer.load`` reads flax checkpoints) unless
``--reset`` is given.  The ``--dp/--tp`` meshes are a later slice of the
port (``ROADMAP.md``).
"""

import argparse
import pathlib
import shutil

import torch

from .data.pipeline import get_dataloaders
from .models.asr import get_model, resolve_device
from .training import get_loss, get_trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('model', type=int, nargs=9,
                        help='arch vector: 2 + 3 + 4 ints')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--epochs', type=int, default=40)
    parser.add_argument('--data', type=str, default='TIMIT')
    parser.add_argument('--rnn', type=lambda s: s not in ('0', 'false', 'False'),
                        default=True)
    parser.add_argument('--exp_folder', type=str, default='results')
    parser.add_argument('--exp_name', type=str, default=None)
    parser.add_argument('--lr', type=float, default=0.0001)
    parser.add_argument('--dropout', type=float, default=0.2)
    parser.add_argument('--dp', type=int, default=None,
                        help='not ported yet (ROADMAP.md)')
    parser.add_argument('--tp', type=int, default=1,
                        help='not ported yet (ROADMAP.md)')
    parser.add_argument('--decoder', type=str, default='beam',
                        choices=['beam', 'greedy'])
    parser.add_argument('--init_scheme', type=str, default=None,
                        choices=['scaled', 'reference', 'he'],
                        help="kernel init (default: the model's 'scaled')")
    parser.add_argument('--adam_eps', type=float, default=None,
                        help="Adam epsilon (default: the trainer's 1e-16; "
                             "pass 1e-7 for the reference optimizer)")
    parser.add_argument('--reset', action='store_true')
    parser.add_argument('--seed', type=int, default=1235)
    parser.add_argument('--dtype', type=str, default=None,
                        choices=['float32', 'bfloat16'],
                        help='encoder compute dtype; default: bfloat16 on '
                             'the card, float32 on the CPU')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--grouped_impl', type=str, default='auto',
                        choices=['auto', 'native', 'masked_dense', 'pallas',
                                 'pallas_split', 'chunked', 'fused',
                                 'fused_aligned'],
                        help="cell implementation: 'auto', 'fused' and "
                             "'fused_aligned' run the fused cell kernels, "
                             "'pallas' and 'pallas_split' the grouped conv "
                             "kernels, 'chunked', 'masked_dense' and "
                             "'native' the JAX package's XLA lowerings in "
                             "stock PyTorch")
    args = parser.parse_args(argv)
    if args.dp or args.tp != 1:
        parser.error('--dp/--tp: the distributed runners are not ported yet '
                     '(see ROADMAP.md)')

    device = resolve_device(args.device)
    if args.dtype is None:
        args.dtype = 'bfloat16' if device.type == 'cuda' else 'float32'
    if device.type == 'cuda' and args.dtype == 'float32':
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
        torch.backends.cudnn.allow_tf32 = False

    arch = [args.model[0:2], args.model[2:5], args.model[5:9]]
    if not args.exp_name:
        flat = '_'.join(map(str, args.model))
        args.exp_name = f'{flat}_b{args.batch_size}_rnn{int(args.rnn)}'
    print(f'Using backend: torch on {device}')
    print(f'    Model vec: {arch}')
    print(f'    Training for {args.epochs} epochs, batch {args.batch_size}, '
          f'lr {args.lr}, dropout {args.dropout}')

    dataloaders = get_dataloaders(args.data, batch_size=args.batch_size)
    model_kw = {'init_scheme': args.init_scheme} if args.init_scheme else {}
    model = get_model(
        arch, use_rnn=args.rnn, dropout_rate=args.dropout, data_norm=True,
        compute_dtype=getattr(torch, args.dtype), device=device,
        grouped_impl=args.grouped_impl,
        generator=torch.Generator().manual_seed(args.seed), **model_kw)
    trainer_kw = {} if args.adam_eps is None else {'adam_eps': args.adam_eps}
    save_dir = pathlib.Path(args.exp_folder) / 'torch'
    if not args.reset:
        adopt_jax_run(pathlib.Path(args.exp_folder) / 'jax' / args.exp_name,
                      save_dir / args.exp_name)
    trainer = get_trainer(dataloaders, get_loss(), device=device,
                          save_dir=save_dir, eval_decoder=args.decoder,
                          **trainer_kw)
    return trainer.train(model, epochs=args.epochs, lr=args.lr,
                         reset=args.reset, model_name=args.exp_name,
                         seed=args.seed)


def adopt_jax_run(jax_dir, out_dir):
    """Copy the JAX run's checkpoints (and their ``.json`` sidecars) into
    ``out_dir`` when it has none of its own, so that ``Trainer.train``
    resumes from them.  Returns the files copied."""
    names = ('latest.ckpt', 'best.ckpt')
    if any((out_dir / n).exists() for n in names):
        return []
    copied = []
    for name in names:
        for src in (jax_dir / name, jax_dir / (name + '.json')):
            if src.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(src, out_dir / src.name)
                copied.append(src)
    if copied:
        print(f'    Resuming the JAX run {jax_dir}')
    return copied


if __name__ == '__main__':
    main()
