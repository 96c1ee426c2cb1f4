"""int8 PTQ on trained weights, the port's twin of
``scripts/quant_per_check.py``: train ``tests/test_per_recipe.py``'s model
(the flagship arch at widths 32/32/48/48, 4 groups, one cell a block, no
LSTM, no dropout) on the tone corpus for 40 epochs at lr 1e-3 with beam
W=12, take the remembered best weights, evaluate them in f32, then their
weights-only int8 quantization (:func:`nbasr_torch.quant.quantize_tree`,
dequantized) on the same loader.  Prints both evaluations and the
relative L2 of the int8 logits against the f32 ones on the val split; on
the card by default, ``--device cpu`` for the plain versions.

    python -m nbasr_torch.tools.quant_per_check [--epochs 40] [--json]
        [--device cpu]
"""

import argparse
import json
import time

import torch

from ..models.asr import get_model
from ..quant import dequantize_tree, quantize_tree
from ..training import get_loss, get_trainer
from .per_run import FLAGSHIP, summary, tone_loaders

__all__ = ['RECIPE', 'build', 'train', 'int8_check', 'main']

#: the JAX test's model (``tests/test_per_recipe.py:55-59``)
RECIPE = dict(use_rnn=False, block_filters=(32, 32, 48, 48), cell_groups=4,
              cells_per_block=(1, 1, 1, 1), init_scheme='scaled',
              cell_dropout=0.0, dropout_rate=0.0)
EPOCHS = 40
LR = 1e-3


def build(device, seed=0):
    """``(loaders, trainer, model)`` of the JAX test's recipe on
    ``device``: the tone corpus at B=8, beam W=12, decay from epoch 100,
    the model drawn from ``seed``."""
    loaders = tone_loaders()
    trainer = get_trainer(loaders, get_loss(), verbose=False, device=device,
                          eval_decoder='beam', beam_width=12,
                          decay_start_epoch=100)
    model = get_model(FLAGSHIP, device=device,
                      generator=torch.Generator().manual_seed(seed), **RECIPE)
    return loaders, trainer, model


def train(trainer, model, epochs=EPOCHS, lr=LR):
    """``Trainer.train`` (which ends on the remembered best weights);
    returns :func:`~nbasr_torch.tools.per_run.summary`'s readings."""
    t0 = time.time()
    history, test_scores = trainer.train(model, epochs=epochs, lr=lr)
    return summary(history, test_scores, time.time() - t0)


@torch.no_grad()
def _logits(trainer, loader):
    return [trainer._eval_logits(trainer._put_batch(b))[0].float()
            for b in loader]


def int8_check(trainer, loader):
    """Evaluate the model's weights as they are (f32), then their int8
    quantization, on ``loader``; the model keeps the int8 weights.
    Returns ``{'f32', 'int8'}`` evaluations and ``rel_l2``, ||int8
    logits - f32 logits|| / ||f32 logits|| over the loader."""
    model = trainer.model
    f32 = trainer.evaluate(loader)
    ref = _logits(trainer, loader)
    params = {n: p.detach() for n, p in model.named_parameters()}
    model.load_state_dict(dequantize_tree(quantize_tree(params)), strict=False)
    int8 = trainer.evaluate(loader)
    got = _logits(trainer, loader)
    num = sum(float(torch.sum((g - r) ** 2)) for g, r in zip(got, ref))
    den = sum(float(torch.sum(r ** 2)) for r in ref)
    return dict(f32={k: float(v) for k, v in f32.items()},
                int8={k: float(v) for k, v in int8.items()},
                rel_l2=(num / den) ** 0.5)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m nbasr_torch.tools.quant_per_check',
        description='int8 PTQ of the tone-corpus recipe\'s trained weights '
                    '(the twin of scripts/quant_per_check.py)')
    p.add_argument('--epochs', type=int, default=EPOCHS)
    p.add_argument('--device', default='cuda')
    p.add_argument('--json', action='store_true',
                   help='also print one JSON line of the readings')
    args = p.parse_args(argv)
    loaders, trainer, model = build(args.device)
    out = train(trainer, model, epochs=args.epochs)
    trainer.recall_best()
    out.update(int8_check(trainer, loaders[3]))
    print('val_ler curve:', [round(v, 3) for v in out['val_ler']])
    print('f32  best-weights:', {k: round(v, 4) for k, v in out['f32'].items()})
    print('int8 best-weights:', {k: round(v, 4) for k, v in out['int8'].items()})
    print(f'int8 logits against f32: relative L2 {out["rel_l2"]:.4e}')
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
