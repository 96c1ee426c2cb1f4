"""The learning proof of the full-width flagship on a tone-coded corpus,
the port's twin of ``scripts/per_flagship_run.py``.

The corpus is ``tests/test_per_recipe.py``'s: each label id is a pure
tone, an utterance 3-6 segments of 0.2 s with a noise floor, drawn from a
numpy ``RandomState`` (the same audio and labels as the JAX test's, bit
for bit).  The model and recipe are the script's: the flagship with its
LSTM, dropout 0.2, bf16, no data norm, ``init_scheme='scaled'``, Adam
eps 1e-16, lr decay from epoch 1000, beam W=12 on a 32-utterance val
split, B=16.  Training runs the whole path (frontend, cells, CTC, beam
search, p39 fold, edit distance); it prints the val LER curve, the test
scores (on the remembered best weights) and the seconds.  On the card by
default; ``--device cpu`` runs the plain versions.

    python -m nbasr_torch.tools.per_run [EPOCHS [LR [N_TRAIN [DROPOUT [RNN
        [DTYPE [ADAM_EPS [N_TONES [DECAY_START]]]]]]]]] [--json]
        [--device cpu] [--block_filters 32,32,48,48 ...]

The positional arguments and their defaults are the JAX script's (10,
1e-3, 256, 0.2, 1, bf16, 1e-16, 4, 1000; DTYPE ``f32`` for float32).
``--json`` also prints one JSON line of the readings; the width options
cut the model for a quick run.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..data.phonemes import PhonemeEncoder
from ..data.pipeline import ArrayDataset, Loader
from ..models.asr import get_model
from ..training import get_loss, get_trainer

__all__ = ['TONE_FREQS', 'FLAGSHIP', 'make_tone_split', 'tone_loaders',
           'tone_freqs', 'build', 'window_stats', 'summary', 'main']

#: the four tones of the JAX test's corpus (Hz)
TONE_FREQS = np.array([400.0, 800.0, 1400.0, 2200.0])
FLAGSHIP = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
#: epochs a window of the val LER curve spans in :func:`window_stats`
WINDOW = 50


def make_tone_split(n, seed, seg=3200, sr=16000, name='', freqs=TONE_FREQS):
    """Utterances of concatenated pure-tone segments; label = tone index
    (1-based).  ``tests/test_per_recipe.py``'s draws, in its order."""
    rng = np.random.RandomState(seed)
    audio, labels = [], []
    for _ in range(n):
        L = rng.randint(3, 7)
        ids = rng.randint(1, len(freqs) + 1, size=L)
        sig = np.concatenate([
            np.sin(2 * np.pi * freqs[i - 1] * np.arange(seg) / sr) * 0.5
            for i in ids])
        # the noise floor keeps the log-mel of quiet bins finite
        sig = sig + rng.randn(len(sig)) * 0.05
        audio.append(sig.astype(np.float32))
        labels.append(ids.astype(np.int32))
    return ArrayDataset(audio, labels, name=name)


def tone_loaders(batch_size=8, n_train=48, n_val=8, freqs=TONE_FREQS):
    """``(encoder, train, val, test)`` of the tone corpus, the val split
    the test split too: by default the JAX test's (48 train and 8 val
    utterances, B=8)."""
    enc = PhonemeEncoder(48)
    train = make_tone_split(n_train, 0, name='TRAIN', freqs=freqs)
    val = make_tone_split(n_val, 1, name='VAL', freqs=freqs)
    ltr = Loader(train, batch_size, shuffle=True, seed=0)
    lva = Loader(val, batch_size)
    return enc, ltr, lva, lva


def tone_freqs(n_tones):
    """The script's tones: the test's four, or ``n_tones`` spread
    geometrically over 300-6000 Hz (ids stay below the encoder's 48)."""
    if n_tones == 4:
        return TONE_FREQS
    if not 1 <= n_tones < 48:
        raise ValueError(f'N_TONES={n_tones} out of vocab range [1, 47]')
    return np.geomspace(300.0, 6000.0, n_tones)


def build(n_train=256, dropout=0.2, rnn=True, dtype=torch.bfloat16,
          adam_eps=1e-16, n_tones=4, decay_start=1000, device='cuda',
          **widths):
    """``(loaders, trainer, model)`` of the script's recipe: ``n_train``
    train and 32 val utterances at B=16, beam W=12, the flagship
    (``widths`` override its widths) drawn from seed 0."""
    loaders = tone_loaders(16, n_train, 32, tone_freqs(n_tones))
    trainer = get_trainer(loaders, get_loss(), verbose=True, device=device,
                          eval_decoder='beam', beam_width=12,
                          decay_start_epoch=decay_start, adam_eps=adam_eps)
    model = get_model(FLAGSHIP, use_rnn=rnn, dropout_rate=dropout,
                      cell_dropout=dropout, data_norm=None,
                      compute_dtype=dtype, init_scheme='scaled',
                      device=device,
                      generator=torch.Generator().manual_seed(0), **widths)
    return loaders, trainer, model


def window_stats(curve, window=WINDOW):
    """``{'best', 'best_epoch', 'window', 'window_means', 'best_window'}``
    of a val LER curve: its least value and 1-based epoch, the means of
    consecutive ``window``-epoch windows, and the least of those."""
    curve = [float(v) for v in curve]
    means = [float(np.mean(curve[i:i + window]))
             for i in range(0, len(curve) - window + 1, window)]
    best = int(np.argmin(curve))
    return dict(best=curve[best], best_epoch=best + 1, window=window,
                window_means=means, best_window=min(means) if means else None)


def summary(history, test_scores, seconds):
    """The readings of a run: the curves, the test scores, the seconds,
    and :func:`window_stats` of the val LER curve."""
    return dict(val_ler=[float(v) for v in history['val_ler']],
                ctc_loss=[float(v) for v in history['ctc_loss']],
                val_ctc_loss=[float(v) for v in history['val_ctc_loss']],
                epoch_seconds=[float(v) for v in history['epoch_seconds']],
                nonfinite_steps=[int(v) for v in history['nonfinite_steps']],
                test={k: float(v) for k, v in test_scores.items()},
                seconds=float(seconds), **window_stats(history['val_ler']))


def _ints(text):
    return tuple(int(v) for v in text.split(','))


def _parser():
    p = argparse.ArgumentParser(
        prog='python -m nbasr_torch.tools.per_run',
        description='the flagship on the tone-coded corpus (the twin of '
                    'scripts/per_flagship_run.py)')
    for name, kind, default in (('epochs', int, 10), ('lr', float, 1e-3),
                                ('n_train', int, 256),
                                ('dropout', float, 0.2), ('rnn', str, '1'),
                                ('dtype', str, 'bf16'),
                                ('adam_eps', float, 1e-16),
                                ('n_tones', int, 4),
                                ('decay_start', int, 1000)):
        p.add_argument(name, type=kind, nargs='?', default=default)
    p.add_argument('--json', action='store_true',
                   help='also print one JSON line of the readings')
    p.add_argument('--device', default='cuda')
    p.add_argument('--block_filters', type=_ints, default=None)
    p.add_argument('--cells_per_block', type=_ints, default=None)
    p.add_argument('--cell_groups', type=int, default=None)
    p.add_argument('--rnn_units', type=int, default=None)
    return p


def main(argv=None):
    """Run the script; returns :func:`summary`'s readings."""
    args = _parser().parse_args(argv)
    widths = {k: getattr(args, k) for k in ('block_filters',
                                            'cells_per_block', 'cell_groups',
                                            'rnn_units')
              if getattr(args, k) is not None}
    rnn = args.rnn != '0'
    _, trainer, model = build(
        args.n_train, args.dropout, rnn,
        torch.float32 if args.dtype == 'f32' else torch.bfloat16,
        args.adam_eps, args.n_tones, args.decay_start, args.device,
        **widths)
    print(f'epochs={args.epochs} lr={args.lr} n={args.n_train} '
          f'dropout={args.dropout} rnn={rnn} dtype={args.dtype} '
          f'adam_eps={args.adam_eps} n_tones={args.n_tones} '
          f'decay_start={args.decay_start} device={trainer.device}'
          + ''.join(f' {k}={v}' for k, v in widths.items()))
    t0 = time.time()
    history, test_scores = trainer.train(model, epochs=args.epochs,
                                         lr=args.lr)
    out = summary(history, test_scores, time.time() - t0)
    print('val_ler curve:', [round(v, 3) for v in out['val_ler']])
    print('test:', out['test'])
    print(f'best {out["best"]:.4f} at epoch {out["best_epoch"]}; '
          f'{WINDOW}-epoch window means {[round(v, 4) for v in out["window_means"]]}')
    print('total', round(out['seconds'], 1), 's')
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
