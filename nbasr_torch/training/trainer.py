"""Single-device trainer of the port: train and eval steps, checkpoints,
metrics.

Counterpart of ``nbasr_tpu/training/trainer.py`` with its API surface
(``init_state / step / train / evaluate / save / load / remember_best /
recall_best``) and recipe: the normalised CTC loss plus
0.01 conv L2, global-norm clipping at 5.0, Adam (b1 0.9, b2 0.999, eps
1e-16 by default — the JAX package's documented deviation from the
reference's 1e-7; ``adam_eps`` overrides it), lr ×0.9 per epoch from epoch
5, best-on-val-LER weights with resume, a final test evaluation on the
best weights, ``scores.pickle``/``test_scores.pickle``.

The step runs where the model lives: the log-mel frontend, the model
(every SearchCell in the cell kernels, forward and backward), the loss
(its CTC recursions in the alpha and beta kernels) and the update.  As
``optax.apply_if_finite`` does, a step whose gradients are not all finite
changes neither the parameters nor Adam's state and is counted.  Metrics
accumulate on the device as (num, den) pairs and are read once per epoch.
Dropout draws from the trainer's own ``torch.Generator`` (seeded ``seed +
1``, as the JAX trainer's dropout key).  Eval decodes with the
merged-prefix beam search, W=12, by default (``eval_decoder='greedy'``
for the greedy decoder); with a ``save_dir``, TensorBoard scalars go to
``<run>/tb`` as the JAX trainer writes them.

Checkpoints: :meth:`Trainer.save` writes the port's own format
(``torch.save``); :meth:`Trainer.load` reads that and the flax msgpack
files the JAX trainer writes (:mod:`nbasr_torch.checkpoint`), so
``train()`` resumes a ``latest.ckpt``/``best.ckpt`` the JAX trainer left in
its folder; :func:`nbasr_torch.checkpoint.save_flax` writes one the JAX
trainer loads.  Not ported yet (``ROADMAP.md``): the profiler hook; the
eval prewarm hides an XLA compile and has no counterpart here.

Data parallelism (:class:`nbasr_torch.parallel.ParallelTrainer`) overrides
three hooks: :meth:`Trainer._objective` (the loss of the global batch),
:meth:`Trainer._sum_metrics` (metric pairs summed over the ranks) and
:attr:`Trainer.is_lead` (only the lead process writes files); the train
step's forward runs through :attr:`Trainer.net`, the model here and its
``DistributedDataParallel`` wrapper there.
"""

import json
import math
import pathlib
import pickle
import time

import torch

from ..checkpoint import is_flax_checkpoint, load_flax
from ..data.phonemes import PhonemeEncoder
from ..models.asr import logits_length, resolve_device
from ..ops.decode import beam_search_decode, greedy_decode
from ..ops.edit_distance import edit_distance
from ..ops.frontend import FrontendConfig, log_mel_spectrogram, \
    mel_weight_matrix
from ..utils.tbwriter import SummaryWriter
from .loss import conv_l2, get_loss
from .metrics import METRIC_KEYS, accumulate, ratios, zeros_like_metrics

__all__ = ['Trainer', 'get_trainer', 'lr_at_epoch']


def lr_at_epoch(base_lr, epoch, decay=0.9, start_epoch=5):
    """lr for 1-based ``epoch``: ×decay per epoch once epoch > start_epoch
    (reference ``callbacks/lrscheduler.py:37-60``)."""
    return base_lr * decay ** max(0, epoch - start_epoch)


class Trainer:
    """Reference-API trainer on one device (``'cuda'`` unless the caller
    asks for the CPU)."""

    def __init__(self, dataloaders, loss=None, device='cuda', save_dir=None,
                 verbose=True, frontend=None, eval_decoder='beam',
                 beam_width=12, strict_numerics=False, decay=0.9,
                 decay_start_epoch=5, clip_norm=5.0, adam_eps=1e-16,
                 tensorboard=True, tb_step_interval=10):
        if eval_decoder not in ('beam', 'greedy'):
            raise ValueError(f'unknown eval_decoder: {eval_decoder!r}')
        encoder, self.data_train, self.data_validate, self.data_test = \
            dataloaders
        self.encoder = encoder
        self.loss = loss or get_loss()
        self.device = resolve_device(device)
        self.save_dir = pathlib.Path(save_dir) if save_dir else None
        self.verbose = verbose
        self.frontend = frontend or FrontendConfig()
        cfg = self.frontend
        self.mel_mat = torch.as_tensor(mel_weight_matrix(
            cfg.num_mel_bins, cfg.num_bins, cfg.sample_rate, cfg.lower_hz,
            cfg.upper_hz), device=self.device)
        self.eval_decoder = eval_decoder
        self.beam_width = beam_width
        #: TensorBoard scalars under ``<run>/tb`` when ``save_dir`` is set:
        #: the running train loss every ``tb_step_interval`` steps and the
        #: per-epoch metrics (reference callbacks/tensorboard.py:16-28)
        self.tensorboard = tensorboard
        self.tb_step_interval = tb_step_interval
        self.strict_numerics = strict_numerics
        self.decay = decay
        self.decay_start_epoch = decay_start_epoch
        self.clip_norm = clip_norm
        self.adam_eps = adam_eps
        self.fold_table = (torch.as_tensor(encoder.fold_table(39),
                                           device=self.device)
                           if isinstance(encoder, PhonemeEncoder) else None)
        self.model = None
        #: the module the train step's forward runs through
        self.net = None
        self.optimizer = None
        self.generator = None
        #: train steps taken, those skipped for non-finite gradients, and
        #: the skipped steps since the last finite one
        self.step_count = 0
        self.nonfinite_steps = 0
        self.nonfinite_run = 0
        self.seed = 0
        self.metrics = None
        self._best_weights = None

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _put_batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _features(self, batch):
        feats = log_mel_spectrogram(batch['audio'], self.frontend, self.mel_mat)
        return feats, batch['feature_size']

    @property
    def is_lead(self):
        """Whether this process writes the run's files (checkpoints,
        TensorBoard, ``metrics.jsonl``, the score pickles)."""
        return True

    def _objective(self, logits, lsize, batch, m):
        """The training loss of a placed batch's logits: the normalised
        CTC loss plus the conv L2; ``m`` receives the metric pairs."""
        ctc = self.loss(logits, lsize, batch['labels'], batch['label_size'],
                        metrics=m, valid=batch['valid'])
        return ctc + conv_l2(self.model)

    def _sum_metrics(self, m):
        """A step's (num, den) pairs summed over the data-parallel ranks:
        one process's own here."""
        return m

    def _loss_and_grads(self, batch):
        """Forward and backward of the training loss on a placed batch; the
        gradients land in ``.grad``.  Returns the step's metric pairs."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        feats, fsize = self._features(batch)
        logits = self.net(feats, fsize, generator=self.generator)
        lsize = logits_length(fsize, feats.shape[1], logits.shape[1])
        m = {}
        self._objective(logits, lsize, batch, m).backward()
        return self._sum_metrics(m)

    def _update(self, lr):
        """clip_by_global_norm, then Adam, then ×(−lr), as the optax chain
        under ``apply_if_finite``: a step with a non-finite gradient is
        skipped and counted.  Finite gradients whose f32 norm overflows go
        through, scaled by ``clip_norm / inf`` = 0, as optax scales them, and
        Adam still steps.  One host read per step (the norm and the largest
        |gradient| together)."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # max |g| is finite iff every gradient is (NaN propagates through max)
        peak = torch.stack(torch._foreach_norm(grads, math.inf)).max()
        norm_host, peak_host = torch.stack([norm, peak.to(norm.dtype)]).tolist()
        if not math.isfinite(peak_host):
            self.nonfinite_steps += 1
            self.nonfinite_run += 1
            for p in params:
                p.grad = None
            return
        self.nonfinite_run = 0
        if norm_host >= self.clip_norm:      # optax: (g / ‖g‖) * max_norm
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.clip_norm)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()

    def _train_step(self, batch, lr):
        m = self._loss_and_grads(batch)
        self._update(lr)
        self.step_count += 1
        self.metrics = accumulate(self.metrics, m)

    def _eval_logits(self, batch):
        """Eval-mode logits of a placed batch and their lengths."""
        self.model.eval()
        feats, fsize = self._features(batch)
        logits = self.model(feats, fsize)
        return logits, logits_length(fsize, feats.shape[1], logits.shape[1])

    def _decode(self, logits, lsize):
        if self.eval_decoder == 'beam':
            return beam_search_decode(logits, lsize, beam_width=self.beam_width)
        return greedy_decode(logits, lsize)

    @torch.no_grad()
    def _eval_step(self, batch, acc):
        logits, lsize = self._eval_logits(batch)
        m = {}
        self.loss(logits, lsize, batch['labels'], batch['label_size'],
                  metrics=m, valid=batch['valid'])
        hyp, hyp_len = self._decode(logits, lsize)
        labels, label_size = batch['labels'], batch['label_size']
        valid = batch['valid']
        den = (label_size.float() * valid).sum()
        # WER: p48 tokens (pre-fold), reference trainer.py:506-507
        wer = edit_distance(hyp, hyp_len, labels, label_size) * valid
        # LER: p39-folded ids, reference trainer.py:502-510
        if self.fold_table is not None:
            fold = self.fold_table
            ref39 = fold[labels.long()]
            hyp39 = fold[hyp.long().clamp(0, fold.shape[0] - 1)]
        else:
            ref39, hyp39 = labels, hyp
        ler = edit_distance(hyp39, hyp_len, ref39, label_size) * valid
        m.update(wer=(wer.sum(), den), ler=(ler.sum(), den))
        return accumulate(acc, self._sum_metrics(m))

    # ------------------------------------------------------------------
    # reference API
    # ------------------------------------------------------------------

    def init_state(self, model, seed=0):
        """Take ``model`` (built on this trainer's device, its weights from
        the generator given to ``get_model``) with a fresh Adam state, step
        count and metrics; dropout draws from a generator seeded
        ``seed + 1``."""
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f'the model is not on {self.device}')
        self.model = self.net = model
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=self.adam_eps)
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.seed = seed
        self.step_count = 0
        self.nonfinite_steps = 0
        self.nonfinite_run = 0
        self.metrics = zeros_like_metrics(('ctc_loss',), self.device)
        return self

    def step(self, batch, training=True, lr=1e-4):
        """One step on a batch (reference ``Trainer.step``): a training
        step returns the running train metrics, an eval step its own."""
        batch = self._put_batch(batch)
        if training:
            self._train_step(batch, lr)
            return ratios(self.metrics)
        return ratios(self._eval_step(batch, zeros_like_metrics(
            METRIC_KEYS, self.device)))

    def gradients(self, batch):
        """``({name: gradient before clipping}, {'ctc_loss': ...})`` of one
        training step on ``batch``, without updating anything but the
        dropout generator."""
        m = self._loss_and_grads(self._put_batch(batch))
        grads = {n: p.grad.detach().clone()
                 for n, p in self.model.named_parameters() if p.grad is not None}
        return grads, ratios(m)

    def evaluate(self, loader, return_transcripts=0):
        """Eval over a loader: ``{'ctc_loss', 'wer', 'ler'}`` ratios.  With
        ``return_transcripts=N``, ``(ratios, transcripts)``: the
        (hypothesis, reference) phoneme sentences of the first N utterances
        of the first batch (reference ``training/tf/trainer.py:493-500``)."""
        acc = zeros_like_metrics(METRIC_KEYS, self.device)
        transcripts = []
        for batch in loader:
            batch = self._put_batch(batch)
            if return_transcripts and not transcripts:
                transcripts = self.transcribe(batch, limit=return_transcripts)
            acc = self._eval_step(batch, acc)
        if return_transcripts:
            return ratios(acc), transcripts
        return ratios(acc)

    @torch.no_grad()
    def transcribe(self, batch, limit=None):
        """Decode a batch to (hypothesis, reference) phoneme sentences, the
        valid rows among the first ``limit``."""
        batch = self._put_batch(batch)
        hyp, hyp_len = (t.cpu().numpy() for t in self._decode(
            *self._eval_logits(batch)))
        valid = batch['valid'].cpu().numpy()
        labels = batch['labels'].cpu().numpy()
        label_size = batch['label_size'].cpu().numpy()
        n = len(hyp) if limit is None else min(limit, len(hyp))
        return [(self.encoder.decode_to_sentence(hyp[b][:hyp_len[b]]),
                 self.encoder.decode_to_sentence(labels[b][:label_size[b]]))
                for b in range(n) if valid[b]]

    def train(self, model, epochs=40, lr=0.0001, reset=False, model_name=None,
              seed=0):
        """Full training run; writes ``scores.pickle`` and
        ``test_scores.pickle`` under ``save_dir``.  Returns ``(history,
        test_scores)``."""
        self.init_state(model, seed=seed)
        # every process loads on resume; only the lead one writes
        lead = self.is_lead
        out_dir = latest_ckpt = best_ckpt = None
        start_epoch, best_val = 1, None
        if self.save_dir is not None:
            out_dir = self.save_dir / model_name if model_name else self.save_dir
            out_dir.mkdir(parents=True, exist_ok=True)
            latest_ckpt, best_ckpt = out_dir / 'latest.ckpt', out_dir / 'best.ckpt'
            if reset:
                for f in (latest_ckpt, best_ckpt):
                    f.unlink(missing_ok=True)
            else:
                if best_ckpt.exists():
                    self.load(best_ckpt)
                    self.remember_best()
                if latest_ckpt.exists():
                    meta = self.load(latest_ckpt)
                    start_epoch = meta.get('epoch', 0) + 1
                    best_val = meta.get('best_val')

        history = {'ctc_loss': [], 'val_ctc_loss': [], 'val_wer': [],
                   'val_ler': [], 'lr': [], 'nonfinite_steps': [],
                   'epoch_seconds': []}

        def forever(loader):
            while True:
                yield from loader

        stream = (iter(self.data_train) if hasattr(self.data_train, 'full')
                  else forever(self.data_train))
        tb = None
        if out_dir is not None and self.tensorboard and lead:
            tb = SummaryWriter(str(out_dir / 'tb'))
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.time()
            epoch_lr = lr_at_epoch(lr, epoch, self.decay, self.decay_start_epoch)
            self.metrics = zeros_like_metrics(('ctc_loss',), self.device)
            skipped = self.nonfinite_steps
            for step_i in range(self.data_train.steps):
                self._train_step(self._put_batch(next(stream)), epoch_lr)
                if (tb is not None and self.tb_step_interval
                        and (step_i + 1) % self.tb_step_interval == 0):
                    # the running epoch-mean train loss, read only here
                    tb.scalar('batch_ctc_loss', ratios(self.metrics)['ctc_loss'],
                              step=self.step_count)
            train_m = ratios(self.metrics)
            notfinite = self.nonfinite_steps - skipped
            if notfinite and self.strict_numerics:
                raise FloatingPointError(
                    f'{notfinite} non-finite update(s) in epoch {epoch}')
            val_m = self.evaluate(self.data_validate)
            history['ctc_loss'].append(train_m['ctc_loss'])
            history['val_ctc_loss'].append(val_m['ctc_loss'])
            history['val_wer'].append(val_m['wer'])
            history['val_ler'].append(val_m['ler'])
            history['lr'].append(epoch_lr)
            history['nonfinite_steps'].append(notfinite)
            history['epoch_seconds'].append(time.time() - t0)
            if best_val is None or val_m['ler'] <= best_val:
                best_val = val_m['ler']
                self.remember_best()
                if best_ckpt and lead:
                    self.save(best_ckpt, epoch=epoch, best_val=best_val)
            if latest_ckpt and lead:
                self.save(latest_ckpt, epoch=epoch, best_val=best_val)
            if tb is not None:
                tb.scalars({'epoch_ctc_loss': train_m['ctc_loss'],
                            'epoch_val_ctc_loss': val_m['ctc_loss'],
                            'epoch_val_wer': val_m['wer'],
                            'epoch_val_ler': val_m['ler'],
                            'lr': epoch_lr}, step=epoch)
                tb.flush()
            if out_dir and lead:
                with open(out_dir / 'metrics.jsonl', 'a') as f:
                    f.write(json.dumps({
                        'epoch': epoch, 'lr': epoch_lr,
                        'ctc_loss': train_m['ctc_loss'],
                        'val_ctc_loss': val_m['ctc_loss'],
                        'val_wer': val_m['wer'], 'val_ler': val_m['ler'],
                        'nonfinite_steps': notfinite,
                        'seconds': history['epoch_seconds'][-1]}) + '\n')
            if self.verbose and lead:
                print(f'Epoch {epoch}: loss {train_m["ctc_loss"]:.4f} '
                      f'val_loss {val_m["ctc_loss"]:.4f} '
                      f'val_per {val_m["ler"]:.4f} lr {epoch_lr:.2e} '
                      f'({history["epoch_seconds"][-1]:.1f}s)')

        if tb is not None:
            tb.close()
        self.recall_best()
        test_m = self.evaluate(self.data_test)
        test_scores = {f'val_{k}': v for k, v in test_m.items()}
        if self.verbose and lead:
            print('Test:', test_scores)
        if out_dir and lead:
            with open(out_dir / 'scores.pickle', 'wb') as f:
                pickle.dump(history, f)
            with open(out_dir / 'test_scores.pickle', 'wb') as f:
                pickle.dump(test_scores, f)
        return history, test_scores

    # -- checkpoints: the port's own format, and the JAX trainer's -------

    def save(self, path, **meta):
        """Model, optimizer, step count and dropout generator state to
        ``path`` (``torch.save``); ``meta`` to ``path + '.json'``."""
        path = pathlib.Path(path)
        torch.save({'model': self.model.state_dict(),
                    'optimizer': self.optimizer.state_dict(),
                    'step': self.step_count,
                    'nonfinite_steps': self.nonfinite_steps,
                    'nonfinite_run': self.nonfinite_run,
                    'generator': self.generator.get_state()}, path)
        path.with_suffix(path.suffix + '.json').write_text(json.dumps(meta))

    def load(self, path):
        """Restore what :meth:`save` wrote, or a checkpoint of the JAX
        trainer (flax msgpack, :func:`nbasr_torch.checkpoint.load_flax`:
        the dropout generator is left alone there); returns its ``meta``.
        The format is told by the file's first bytes: ``torch.save``'s zip
        opens with ``PK``, flax's msgpack with a map header."""
        path = pathlib.Path(path)
        with open(path, 'rb') as f:
            head = f.read(2)
        if is_flax_checkpoint(head):
            return load_flax(self, path)
        if head != b'PK':
            raise ValueError(f'{path}: neither a torch.save checkpoint nor a '
                             f'flax one (first bytes {head!r})')
        state = torch.load(path, map_location=self.device)
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        self.step_count = state['step']
        self.nonfinite_steps = state['nonfinite_steps']
        self.nonfinite_run = state.get('nonfinite_run', 0)
        self.generator.set_state(state['generator'].cpu())
        meta_file = path.with_suffix(path.suffix + '.json')
        return json.loads(meta_file.read_text()) if meta_file.exists() else {}

    def remember_best(self):
        self._best_weights = {k: v.detach().to('cpu', copy=True)
                              for k, v in self.model.state_dict().items()}

    def recall_best(self):
        if self._best_weights is not None:
            self.model.load_state_dict(self._best_weights)


def get_trainer(dataloaders, loss=None, save_dir=None, verbose=True, **kwargs):
    return Trainer(dataloaders, loss, save_dir=save_dir, verbose=verbose,
                   **kwargs)
