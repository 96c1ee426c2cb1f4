"""Mixes of kind ``serve``: one ``StreamingASR`` at a time serving a group
of ``streams`` live streams in lockstep, each pushing its audio in
``piece_s`` pieces back to back (a backlog, a closed loop) and flushing at
its end; ``StreamingGreedyDecoder`` decodes every emitted chunk.  When a
group ends the next starts.  Rows whose stream has ended idle until their
group ends; only valid audio counts.

Set-up builds the model through its architecture's ``build`` with the
run's weights and serves one warm-up group of ``warmup_stream_s``
streams.  The window then serves groups until ``--seconds`` have passed,
at a call's end.  With ``--trace 1`` its first half is an unprofiled
stretch (``mfu.serve``, ``serve_step_p95_ms``: the 95th percentile of its
emitting calls, each from the call until its tokens are on the host),
then ``trace_calls`` emitting calls run under the profiler on the device
alone, and ``trace_calls`` more with the host and the benchmark's spans.

Correctness: of the streams of the groups that finished in the window,
the longest one and ``sample_streams - 1`` drawn from the seed (each
group offers its longest stream and one drawn one); their streamed logits
and tokens are held against the reference's offline forward of each
whole stream, zero-padded and masked to its group's padded length ``Tp =
max(ceil(F / C) * C, hl + C + hr)`` frames (``F`` the group's longest
stream in frames, ``C`` the chunk, ``hl``, ``hr`` the encoder's context):
the length whose offline forward streaming reproduces exactly, ends
included.
"""

import gc

import numpy as np
import torch

from .. import archs, traffic, trace
from ..common import build_model, by_parts, now, profiled_pace, syncer
from ..reference import frontend as ref_fe
from ..reference import model as ref

FRAME_S = 0.010


class _Group:
    """One group of streams: its lengths, its audio from the bank."""

    def __init__(self, lengths, offsets, bank, piece):
        self.lengths, self.offsets, self.bank = lengths, offsets, bank
        self.piece = piece
        self.pushes = -(-int(lengths.max()) // piece)

    def block(self, k):
        B, piece = len(self.lengths), self.piece
        out = np.zeros((B, piece), np.float32)
        nv = np.clip(self.lengths - k * piece, 0, piece)
        for r in np.nonzero(nv)[0]:
            o = self.offsets[r] + k * piece
            out[r, :nv[r]] = self.bank[o:o + nv[r]]
        return out, nv

    def audio(self, r):
        o = self.offsets[r]
        return self.bank[o:o + self.lengths[r]]


def _serve_group(model, mix, group, device, on_call, wrap=None):
    """Serve one group; ``on_call(seconds, chunks, streamer)`` after each
    call.  Returns the emitted ``(logits, valid)`` chunks and the decoder,
    or None where ``on_call.stop()`` ended the group early."""
    from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder
    s = StreamingASR(model, chunk_frames=mix['chunk_frames'],
                     batch_size=len(group.lengths), device=device)
    dec = StreamingGreedyDecoder(len(group.lengths))
    undo = wrap(s, dec) if wrap else None
    kept = []
    for k in range(group.pushes + 1):
        t = now()
        if k < group.pushes:
            block, nv = group.block(k)
            chunks = s.push(block, nv)
        else:
            chunks = s.flush()
        for logits, valid in chunks:
            dec.push(logits, valid)
        on_call(now() - t, chunks, s)
        kept += chunks
        if on_call.stop():
            return None
    if undo:
        undo()
    return kept, dec


def _rows(kept, r):
    return torch.cat([lg[r, :int(v[r])] for lg, v in kept], dim=0)


class _Calls:
    """The window's bookkeeping of emitting calls."""

    def __init__(self, deadline=None, limit=None):
        self.deadline, self.limit = deadline, limit
        self.lat, self.chunks, self.frames, self.bad = [], 0, 0, None
        self.marks = []            # (time, valid frames so far) a call

    def __call__(self, secs, chunks, s):
        if chunks:
            self.lat.append(secs)
        for lg, v in chunks:
            self.chunks += 1
            self.frames += int(np.sum(v))
            bad = (~torch.isfinite(lg)).any().to(torch.int32)
            self.bad = bad if self.bad is None else self.bad + bad
        self.marks.append((now(), self.frames))

    def stop(self):
        if self.limit is not None:
            return len(self.lat) >= self.limit
        return self.deadline is not None and now() >= self.deadline


def _serve_calls(model, mix, groups, device, book, wrap=None):
    """Serve ``groups`` in turn until ``book`` says stop."""
    for g in groups:
        if _serve_group(model, mix, g, device, book, wrap) is None:
            return


def _profiled(model, mix, groups, device, sync, name, calls):
    """``calls`` emitting calls under the profiler on the device alone,
    then ``calls`` more with the host and the benchmark's spans, each
    stretch from the first of ``groups`` on; the two traces, the second
    stretch's cell calls' shapes and each stretch's bookkeeping."""
    dev_book = _Calls(limit=calls)
    with trace.profile(name, sync, spans=False) as dev:
        _serve_calls(model, mix, groups, device, dev_book)
    shapes, undo = trace.hook_cells(model)

    def wrap(s, dec):
        fns = [trace.wrap_methods(s, {'push': 'push', 'flush': 'push',
                                      '_featurize': 'frontend',
                                      '_device_step': 'device_step'}),
               trace.wrap_methods(dec, {'push': 'decode'})]
        return lambda: [f() for f in fns]

    book = _Calls(limit=calls)
    with trace.profile(name, sync, spans=True) as prof:
        _serve_calls(model, mix, groups, device, book, wrap)
    undo()
    return dev.trace, prof.trace, shapes, dev_book, book


def run(cell, cfg, mix, seed, seconds, traced, device, t0):
    """One run of a ``serve`` cell: set-up, the window, and what the
    result and the comparison need (``perfbench.run`` reads it)."""
    sync = syncer(device)
    arch = archs.find(cfg)
    model, _ = build_model(cfg, mix, seed, device)
    model.eval()
    sr = traffic.SAMPLE_RATE
    piece = int(round(mix['piece_s'] * sr))
    lengths = traffic.stream_lengths(mix, seed)
    bank = traffic.bank(mix, seed)
    offsets = traffic.stream_offsets(mix, seed, lengths, len(bank))
    pick = traffic.rng(seed, 5)
    groups = [_Group(lengths[g], offsets[g], bank, piece)
              for g in range(len(lengths))]
    warm = np.full(mix['streams'], int(mix['warmup_stream_s'] * sr))
    with torch.no_grad():
        _serve_group(model, mix, _Group(warm, offsets[0], bank, piece),
                     device, _Calls())
    sync()
    setup_s = now() - t0
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    out = {'metrics': {}, 'layer': {'cfg': cfg, 'esize': 4}}
    span = seconds / 2 if traced else seconds
    start = now()
    book = _Calls(deadline=start + span)
    done = []                  # (group, row, logits, tokens, padded frames)
    with torch.no_grad():
        for gi in range(10 ** 6):
            g = groups[gi % len(groups)]
            res = _serve_group(model, mix, g, device, book)
            if res is None:
                break
            kept, dec = res
            longest = int(np.argmax(g.lengths))
            drawn = int(pick.integers(len(g.lengths)))
            tp = _padded_frames(cfg, mix, g)
            for r in dict.fromkeys([longest, drawn]):
                done.append((g, r, _rows(kept, r), list(dec.tokens[r]), tp))
        sync()
    elapsed = now() - start
    ts = arch.output_stride(cfg)
    audio_s = book.frames * ts * FRAME_S
    marks = [(t, f * ts * FRAME_S) for t, f in book.marks]
    books = [book]
    attempted = book.chunks
    lat = np.array(book.lat)
    note = (f'{len(lat)} emitting calls, {book.chunks} device steps, '
            f'{audio_s:.3f} audio-s, {elapsed:.3f} s; audio-s/s by fifths '
            f'of the window: {by_parts(marks, start, start + elapsed)}')
    if traced:
        # the offline forward's FLOPs of the emitted valid frames
        out['layer'].update(
            stretch_flops=arch.algorithmic_flops(cfg, 1, book.frames * ts,
                                                 train=False),
            stretch_seconds=elapsed,
            stretch_p95_ms=float(np.percentile(lat, 95)) * 1e3)
        with torch.no_grad():
            dev, spans, shapes, db, sb = _profiled(
                model, mix, groups[::-1], device, sync, cell['name'],
                mix['trace_calls'])
        out['layer'].update(device=dev, steps=db.chunks, spans=spans,
                            cell_calls=shapes)
        books += [db, sb]
        attempted += db.chunks + sb.chunks
        note += '; ' + profiled_pace(
            elapsed / book.chunks, dev.window_seconds() / db.chunks,
            spans.window_seconds() / sb.chunks)
    else:
        out['metrics']['serve_audio_s_per_s'] = audio_s / elapsed
    out['memory_peak'] = (torch.cuda.max_memory_allocated(device)
                          if device.type == 'cuda' else 0)
    failed = sum(int(b.bad) for b in books if b.bad is not None)
    out.update(setup_s=setup_s, attempted=attempted, failed=failed,
               print=note, plain_launches=None)
    if device.type == 'cuda':
        from nbasr_torch.ops import fused_cell
        out['plain_launches'] = fused_cell.LAUNCHES['plain']
    del model
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    sample = _sample(done, mix['sample_streams'], traffic.rng(seed, 6))
    out['check'] = lambda rnd=ref.identity: compare(cfg, seed, device,
                                                    sample, ts, rnd)
    return out


def _padded_frames(cfg, mix, group):
    """The group's padded length in frames (see the module docstring)."""
    hl, hr = archs.find(cfg).halo(cfg)
    C = mix['chunk_frames']
    f = ref_fe.num_frames(int(group.lengths.max()))
    return max(-(-f // C) * C, hl + C + hr)


def _sample(done, n, r):
    """The longest finished stream and ``n - 1`` more drawn from ``r``."""
    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: -len(done[i][2]))
    rest = order[1:]
    r.shuffle(rest)
    return [done[i] for i in [order[0]] + rest[:n - 1]]


def compare(cfg, seed, device, sample, ts, rnd=ref.identity):
    """The numbers compared on the sampled streams: the widest logit gap
    over the stream's largest reference logit, the widest gap by which a
    served frame's id lies below the reference's best logit, and the
    streams whose decoded tokens differ from the greedy collapse of the
    served ids."""
    if not sample:
        return {'streams': 0}
    from ..weights import generate
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = generate(cfg, seed, device)
        arch = archs.find(cfg)
        stats = ref.load_stats()
        logits, fsize = [], []
        for g, r, _, _, tp in sample:
            a = g.audio(r)
            audio = np.zeros((1, ref_fe.WINDOW + (tp - 1) * ref_fe.HOP),
                             np.float32)
            audio[0, :len(a)] = a
            fsize.append(ref_fe.num_frames(len(a)))
            with torch.no_grad():
                feats = ref_fe.log_mel(torch.as_tensor(audio, device=device))
                fs = torch.as_tensor(fsize[-1:], device=device)
                logits.append(arch.forward(w, cfg, feats, fs, stats,
                                           rnd=rnd)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    logit = gap = 0.0
    tokens = 0
    for i, (g, r, prog, toks, _) in enumerate(sample):
        n = fsize[i] // ts
        rl = logits[i][:n]
        prog = prog.to(rl.device)
        if prog.shape[0] != n:         # frames missing or extra
            return {'logit': float('inf'), 'gap': float('inf'),
                    'tokens': len(sample)}
        logit = max(logit, float((prog - rl).abs().max()
                                 / rl.abs().max()))
        ids = prog.argmax(-1)
        gap = max(gap, float((rl.max(-1).values
                              - rl.gather(1, ids[:, None])[:, 0]).max()))
        col = ids.cpu().numpy()
        keep = (col != 0) & (col != np.concatenate([[-1], col[:-1]]))
        tokens += int(list(col[keep]) != toks)
    return {'logit': logit, 'gap': gap, 'tokens': tokens}
