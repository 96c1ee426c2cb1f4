"""Batched streaming inference: exact chunked execution of the ASR model.

Counterpart of ``nbasr_tpu/serving.py``, with the same host bookkeeping:
every device step processes one fixed-size feature window ``[B, hl + C +
hr, 80]`` and emits ``C // ts`` logit frames; the window carries the
encoder's :func:`~nbasr_torch.parallel.seqparallel.encoder_halo`, so the
emitted logits equal the offline model on the utterance zero-padded to
``Tp = max(ceil(F_max / C) * C, hl + C + hr)`` frames with the true mask;
flush-time windows are clipped at ``Tp``; the LSTM head threads its
``(c, h)`` carry from chunk to chunk; ``B`` streams advance in lockstep
with per-row validity masks.  The frontend and the device step run on the
model's device; on the card every SearchCell is one launch of the fused
cell kernel (18 per step for the flagship).

``quantize=True`` serves int8 weights (:mod:`nbasr_torch.quant`): the
streamer keeps each kernel on the device as int8 plus f32 scales, holds no
f32 copy of them and no reference to the caller's parameters, and each
device step dequantizes them to f32 before it runs the model (whose cells
still run the fused cell kernel; a bf16 model casts the f32 weights as it
always does).

With :mod:`nbasr_torch.utils.tracing` on, each call is a span: ``serve.push``
and ``serve.flush`` (their ``id`` the call's index), inside them
``serve.frontend`` (the log-mel and its copy to the host) and
``serve.device_step`` (with ``serve.dequant`` when quantized), and
``serve.decode`` for each :meth:`StreamingGreedyDecoder.push`.
"""

import copy

import numpy as np
import torch
from torch.func import functional_call

from .models.asr import logits_length, resolve_device
from .ops.frontend import FrontendConfig, log_mel_spectrogram, \
    mel_weight_matrix, num_frames
from .parallel.seqparallel import encoder_halo
from .quant import dequantize_tree, quantize_tree
from .utils import tracing

__all__ = ['StreamingASR', 'StreamingGreedyDecoder']


class StreamingGreedyDecoder:
    """Incremental CTC greedy decode over emitted logit chunks; the dedup
    state carries across chunks, so the concatenated emission equals
    :func:`nbasr_torch.ops.decode.greedy_decode` on the full logits."""

    def __init__(self, batch_size, blank=0):
        self.blank = blank
        self._prev = np.full(batch_size, -1, np.int64)
        self.tokens = [[] for _ in range(batch_size)]

    def push(self, logits, valid_len):
        """logits [B, n, V] (tensor or array); valid_len [B] valid frames.
        Traced as the span ``serve.decode``."""
        with tracing.span('serve.decode'):
            ids = torch.as_tensor(logits).argmax(dim=-1).cpu().numpy()
            for b in range(ids.shape[0]):
                for t in range(int(valid_len[b])):
                    tok = ids[b, t]
                    if tok != self.blank and tok != self._prev[b]:
                        self.tokens[b].append(int(tok))
                    self._prev[b] = tok
            return self.tokens


class StreamingASR:
    """Exact chunked streaming runner for an :class:`ASRModel` on ``device``.

    ``model`` must already live on ``device`` (``get_model(...,
    device=...)``); it runs in its own ``compute_dtype``.  ``chunk_frames``
    (feature frames emitted per device step) must be a multiple of the
    model's total time reduction.  ``quantize=True`` serves the model's
    weights int8 (see the module docstring); the caller may then drop its
    model.

    Usage::

        s = StreamingASR(model, chunk_frames=240, batch_size=B)
        for audio_block in stream:            # [B, S] float arrays
            for logits, valid in s.push(audio_block, n_valid):
                decoder.push(logits, valid)
        for logits, valid in s.flush():
            decoder.push(logits, valid)
    """

    def __init__(self, model, chunk_frames=240, batch_size=1, frontend=None,
                 quantize=False, device='cuda'):
        self.device = resolve_device(device)
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f'the model is not on {self.device}; build it '
                             f'with get_model(..., device={str(device)!r})')
        if self.device.type == 'cuda' and model.compute_dtype == torch.float32:
            # f32 serving means f32: cuDNN convs default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        #: the int8 tree (``quant.quantize_tree``) and the model's buffers,
        #: which a quantized streamer runs its skeleton with
        self.qparams = self._buffers = None
        if quantize:
            self.qparams = quantize_tree(dict(model.named_parameters()))
            self._buffers = {n: b.clone() for n, b in model.named_buffers()}
            model = _skeleton(model)
        self.model = model
        self.frontend = frontend or FrontendConfig()
        self.ts = int(np.prod(model.block_strides))
        if chunk_frames % self.ts:
            raise ValueError(f'chunk_frames={chunk_frames} must be a '
                             f'multiple of the time reduction {self.ts}')
        self.C = chunk_frames
        self.Co = chunk_frames // self.ts
        self.hl, self.hr = encoder_halo(model)
        self.Wf = self.hl + self.C + self.hr
        self.B = batch_size
        #: device steps run so far
        self.steps = 0
        #: push and flush calls so far (the ``id`` of their spans)
        self.calls = 0

        cfg = self.frontend
        self._mel = torch.as_tensor(mel_weight_matrix(
            cfg.num_mel_bins, cfg.num_bins, cfg.sample_rate, cfg.lower_hz,
            cfg.upper_hz), device=self.device)
        # --- host stream state ---
        self._samples = np.zeros((batch_size, 0), np.float32)
        self._sample_base = 0          # global sample index of _samples[:, 0]
        self._valid_samples = np.zeros(batch_size, np.int64)
        self._feats = np.zeros((batch_size, 0, cfg.num_mel_bins), np.float32)
        self._feat_base = 0            # global frame index of _feats[:, 0]
        self._next_chunk = 0
        self._flushed = False
        self._carry = self._init_carry()

    # ------------------------------------------------------------------
    @property
    def latency_frames(self):
        """Algorithmic look-ahead + chunking latency, in feature frames."""
        return self.hr + self.C

    @property
    def latency_seconds(self):
        return self.latency_frames * self.frontend.hop / self.frontend.sample_rate

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _device_step(self, window, mask, trim_off, carry):
        """window [B, Wf, F] -> logits [B, Co, V] for encoder output frames
        [trim_off, trim_off + Co) of the window, advancing the LSTM carry;
        a quantized streamer dequantizes its weights first."""
        with tracing.span('serve.device_step'):
            run = self.model
            if self.qparams is not None:
                with tracing.span('serve.dequant'):
                    tensors = {**dequantize_tree(self.qparams),
                               **self._buffers}
                run = lambda *a, **k: functional_call(self.model, tensors, a,
                                                      k)
            enc = run(window, mask=mask, stage='encode')
            trim = min(max(trim_off, 0), enc.shape[1] - self.Co)
            logits, carry = run(enc[:, trim:trim + self.Co], stage='head',
                                rnn_carry=carry, return_rnn_carry=True)
            self.steps += 1
            return logits, carry

    def _init_carry(self):
        if not self.model.use_rnn:
            return None
        z = torch.zeros((self.B, self.model.rnn_units),
                        dtype=self.model.compute_dtype, device=self.device)
        return (z, z)

    @torch.inference_mode()
    def _featurize(self, audio):
        with tracing.span('serve.frontend'):
            x = torch.as_tensor(audio, device=self.device)
            return log_mel_spectrogram(x, self.frontend,
                                       self._mel).cpu().numpy()

    # ------------------------------------------------------------------
    def push(self, audio, n_valid=None):
        """Feed ``audio [B, S]`` samples; returns ready (logits, valid) chunks.

        ``n_valid [B]`` marks how many of this block's samples are real per
        row (default: all).  Rows whose stream has ended keep getting zero
        blocks with ``n_valid 0`` until the batch flushes.
        """
        self.calls += 1
        with tracing.span('serve.push', self.calls - 1):
            if self._flushed:
                raise RuntimeError('push() after flush()')
            audio = np.asarray(audio, np.float32)
            if audio.ndim == 1:
                audio = audio[None, :]
            if audio.shape[0] != self.B:
                raise ValueError(f'expected batch {self.B}, '
                                 f'got {audio.shape[0]}')
            n_valid = (np.full(self.B, audio.shape[1], np.int64)
                       if n_valid is None else np.asarray(n_valid, np.int64))
            base = self._sample_base + self._samples.shape[1]
            # Only rows with new valid samples advance their valid end: a
            # block with n_valid == 0 says nothing about validity up to
            # `base`.
            self._valid_samples = np.where(
                n_valid > 0, np.maximum(self._valid_samples, base + n_valid),
                self._valid_samples)
            self._samples = np.concatenate([self._samples, audio], axis=1)

            cfg = self.frontend
            have = self._samples.shape[1]
            n_new = max((have - cfg.window) // cfg.hop + 1, 0)
            if n_new:
                used = self._samples[:, :(n_new - 1) * cfg.hop + cfg.window]
                self._feats = np.concatenate(
                    [self._feats, self._featurize(used)], axis=1)
                drop = n_new * cfg.hop
                self._samples = self._samples[:, drop:]
                self._sample_base += drop
            return self._drain(final=False)

    def flush(self):
        """End all streams: process the tail (zero-padded, masked) chunks.
        Afterwards ``logit_lengths`` gives the per-row valid logit frames."""
        self.calls += 1
        with tracing.span('serve.flush', self.calls - 1):
            self._flushed = True
            return self._drain(final=True)

    @property
    def frames_valid(self):
        """Per-row true feature-frame counts seen so far."""
        return num_frames(self._valid_samples, self.frontend)

    @property
    def logit_lengths(self):
        """Per-row valid logit frames (same rule the trainer uses)."""
        f = self.frames_valid
        t_in = max(int(f.max()), 1) if f.size else 1
        t_in = -(-t_in // self.ts) * self.ts
        return logits_length(torch.as_tensor(f), t_in, t_in // self.ts).numpy()

    # ------------------------------------------------------------------
    def _tp_bound(self):
        """Canonical padded stream length (a lower bound until flush):
        max(ceil(F_max/C)*C, Wf)."""
        f_max = int(self.frames_valid.max()) if self.B else 0
        return max(-(-f_max // self.C) * self.C, self.Wf)

    def _emit(self, c, tp=None):
        """Run chunk ``c`` (output frames [c*Co, (c+1)*Co)); ``tp`` set
        (flush) clips the window at the canonical padded end."""
        w = max(c * self.C - self.hl, 0)       # global window start (mult of ts)
        if tp is not None:
            w = min(w, tp - self.Wf)
        lo = w - self._feat_base
        assert lo >= 0, 'window start fell off the retained feature buffer'
        win = self._feats[:, lo:lo + self.Wf]
        pad = self.Wf - win.shape[1]
        if pad > 0:
            win = np.pad(win, ((0, 0), (0, pad), (0, 0)))
        pos = w + np.arange(self.Wf)
        mask = pos[None, :] < self.frames_valid[:, None]
        trim = (c * self.C - w) // self.ts
        logits, self._carry = self._device_step(
            torch.as_tensor(win, device=self.device),
            torch.as_tensor(mask, device=self.device), trim, self._carry)
        valid = np.clip(self.logit_lengths - c * self.Co, 0, self.Co)
        return logits, valid

    def _drain(self, final):
        out = []
        while True:
            c = self._next_chunk
            need = c * self.C + self.C + self.hr      # frames to emit chunk c
            have = self._feats.shape[1] + self._feat_base
            f_max = int(self.frames_valid.max()) if self.B else 0
            if final:
                if c * self.C >= f_max:               # all valid frames emitted
                    return out
            elif have < need:
                return out
            out.append(self._emit(c, tp=self._tp_bound() if final else None))
            self._next_chunk += 1
            # Retain every frame a future window can still touch: flush-time
            # clipping can pull window starts back to tp - Wf.
            keep_from = max(0, min((c + 1) * self.C - self.hl,
                                   self._tp_bound() - self.Wf))
            drop = keep_from - self._feat_base
            if drop > 0:
                self._feats = self._feats[:, drop:]
                self._feat_base = keep_from


def _skeleton(model):
    """A copy of ``model`` whose parameters are empty tensors on the meta
    device: the module structure a quantized streamer runs through
    ``functional_call``, without an f32 weight or a reference to the
    caller's parameters (its buffers are copied)."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device='meta'),
                                      requires_grad=False)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)
