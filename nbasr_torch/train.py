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
``--reset`` is given.

``--dp N`` trains data-parallel, one process per device, through
:class:`nbasr_torch.parallel.ParallelTrainer` (NCCL on the cards, gloo with
``--device cpu``), each rank on its shard of every batch:

    torchrun --nproc_per_node N -m nbasr_torch.train 1 0 1 0 0 1 0 0 0 \
        --dp N --data TIMIT

``--batch_size`` is the global batch.  Only rank 0 writes the run's files.
``--tp`` above 1 (tensor parallelism) is the last port slice of
``ROADMAP.md``.
"""

import argparse
import pathlib
import shutil

import torch
import torch.distributed as dist

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
                        help='data-parallel processes (run under torchrun '
                             '--nproc_per_node DP)')
    parser.add_argument('--tp', type=int, default=1,
                        help='tensor parallelism: not ported yet (ROADMAP.md)')
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
    if args.tp != 1:
        from .parallel.mesh import TP_LATER
        parser.error(f'--tp {args.tp}: {TP_LATER}')
    if args.dp:
        from .parallel.mesh import initialize_distributed, local_device
        device = local_device(args.device)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        rank, world = initialize_distributed(device=device)
        if not dist.is_initialized() or world != args.dp:
            parser.error(f'--dp {args.dp} needs as many processes in one '
                         f'group, one per device: run under torchrun '
                         f'--nproc_per_node {args.dp}')
        try:
            return _train(args, device, rank, world)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return _train(args, resolve_device(args.device))


def _train(args, device, rank=0, world=1):
    """The run of ``main``'s arguments on ``device``: data-parallel when
    ``args.dp`` is set, rank ``rank`` of ``world``."""
    if args.dtype is None:
        args.dtype = 'bfloat16' if device.type == 'cuda' else 'float32'
    if device.type == 'cuda' and args.dtype == 'float32':
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
        torch.backends.cudnn.allow_tf32 = False

    arch = [args.model[0:2], args.model[2:5], args.model[5:9]]
    if not args.exp_name:
        flat = '_'.join(map(str, args.model))
        args.exp_name = f'{flat}_b{args.batch_size}_rnn{int(args.rnn)}'
    if rank == 0:
        print(f'Using backend: torch on {device}'
              + (f', data-parallel over {world} processes' if args.dp else ''))
        print(f'    Model vec: {arch}')
        print(f'    Training for {args.epochs} epochs, batch '
              f'{args.batch_size}, lr {args.lr}, dropout {args.dropout}')

    dataloaders = get_dataloaders(args.data, batch_size=args.batch_size,
                                  num_shards=world, shard_index=rank)
    model_kw = {'init_scheme': args.init_scheme} if args.init_scheme else {}
    model = get_model(
        arch, use_rnn=args.rnn, dropout_rate=args.dropout, data_norm=True,
        compute_dtype=getattr(torch, args.dtype), device=device,
        grouped_impl=args.grouped_impl,
        generator=torch.Generator().manual_seed(args.seed), **model_kw)
    trainer_kw = {} if args.adam_eps is None else {'adam_eps': args.adam_eps}
    save_dir = pathlib.Path(args.exp_folder) / 'torch'
    if not args.reset and rank == 0:
        adopt_jax_run(pathlib.Path(args.exp_folder) / 'jax' / args.exp_name,
                      save_dir / args.exp_name)
    if args.dp:
        from .parallel import ParallelTrainer
        dist.barrier()              # rank 0 has adopted the JAX run's files
        trainer = ParallelTrainer(dataloaders, get_loss(), device=device,
                                  save_dir=save_dir,
                                  eval_decoder=args.decoder, **trainer_kw)
    else:
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
