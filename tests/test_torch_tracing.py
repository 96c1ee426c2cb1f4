"""The port's spans and counters (nbasr_torch.utils.tracing) on the CPU at
reduced widths: off, they add no range, hook or record; on, a train step
holds every span at its documented nesting, each module's backward range
holds the backward nodes of its own forward ops, the counters and self
times add up, and the program's outputs are bit-equal either way;
``Trainer(profile_dir=...)`` writes the program's ranges."""

import collections
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import get_model
from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder
from nbasr_torch.training import Trainer
from nbasr_torch.utils import tracing

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
# two blocks (the second conv's input needs a gradient), dropout on
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(16, 16),
          cells_per_block=(1, 1), cell_groups=4, rnn_units=8,
          dropout_rate=0.2)
DATA = 'synthetic:6'
B = 2
EVAL = 'autograd::engine::evaluate_function: '

TRAIN_SPANS = {'step': {'step.h2d', 'step.forward', 'step.backward',
                        'step.update'},
               'step.update': {'step.norm_read', 'step.optimizer'},
               'step.forward': {'block_conv', 'cell', 'lstm', 'ctc.forward'},
               'step.backward': {'ctc.backward', 'lstm.backward',
                                 'cell.backward', 'block_conv.backward'}}


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _model():
    return get_model(ARCH, device='cpu', generator=torch.Generator()
                     .manual_seed(0), **KW)


def _trainer(**kw):
    loaders = get_dataloaders(DATA, batch_size=B, curriculum=())
    tr = Trainer(loaders, device='cpu', verbose=False, eval_decoder='greedy',
                 tensorboard=False, **kw)
    return tr, loaders


def _batch(loaders):
    return next(iter(loaders[1]))


def _events(prof, tmp_path):
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())['traceEvents']
            if e.get('ph') == 'X']


def _ranges(events):
    """``{span name: [(tid, start, end, args)]}`` of the ``nbasr.`` ranges."""
    out = collections.defaultdict(list)
    for e in events:
        if e['name'].startswith(tracing.PREFIX):
            out[e['name'][len(tracing.PREFIX):]].append(
                (e['tid'], e['ts'], e['ts'] + e['dur'], e['args']))
    return out


def _inside(inner, outer):
    return any(t == inner[0] and s <= inner[1] and inner[2] <= e
               for t, s, e, _ in outer)


def _serve(model, audio, nv):
    s = StreamingASR(model, chunk_frames=16, batch_size=audio.shape[0],
                     device='cpu')
    dec = StreamingGreedyDecoder(audio.shape[0])
    chunks = s.push(audio, nv) + s.flush()
    for logits, valid in chunks:
        dec.push(logits, valid)
    return torch.cat([lg for lg, _ in chunks], dim=1), dec.tokens


def _audio():
    rng = np.random.RandomState(0)
    return ((rng.randn(2, 9000) * 0.1).astype(np.float32),
            np.array([9000, 6000]))


def test_off_adds_no_range_hook_or_record(tmp_path, monkeypatch):
    assert not tracing.is_enabled()
    null = tracing.span('a', id=3)
    assert null is tracing.span('b') and isinstance(
        null, contextlib.nullcontext)
    tracing.count('c', 5)
    hooks = []
    real = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, 'register_hook',
                        lambda t, fn: hooks.append(fn) or real(t, fn))
    tr, loaders = _trainer()
    tr.init_state(_model())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(_batch(loaders))
        with torch.no_grad():
            _serve(tr.model.eval(), *_audio())
    assert not _ranges(_events(prof, tmp_path))
    assert hooks == []
    assert tracing.snapshot() == {'spans': {}, 'counts': {}}


def test_train_step_spans_nest_and_add_up(tmp_path):
    tr, loaders = _trainer()
    tr.init_state(_model())
    frames = []
    hook = tr.model.lstm.register_forward_pre_hook(
        lambda m, a: frames.append(a[0].shape[1]))
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
        batch = _batch(loaders)
        tr.step(batch)
    hook.remove()
    assert not tracing.is_enabled()
    events = _events(prof, tmp_path)
    ranges = _ranges(events)
    assert {'loader.batch', *TRAIN_SPANS, *set().union(
        *TRAIN_SPANS.values())} <= set(ranges)
    (step,) = ranges['step']
    assert step[3]['id'] == 0                  # the step count
    assert not _inside(ranges['loader.batch'][0], ranges['step'])
    for parent, children in TRAIN_SPANS.items():
        for child in children:
            assert all(_inside(r, ranges[parent]) for r in ranges[child]), \
                (parent, child)
    # a module's backward range holds exactly the backward nodes of the
    # ops its forward range recorded; the first block conv's, whose input
    # needs no gradient, is closed by its first parameter's gradient
    nodes = {e['name'][len(EVAL):] for e in events
             if e['name'].startswith(EVAL)}
    backward = [e for e in events if e['name'] in nodes
                and 'Sequence number' in e['args']]
    for name, calls in (('lstm', 1), ('block_conv', 2), ('cell', 2)):
        fwd = [{e['args']['Sequence number'] for e in events
                if 'Sequence number' in e['args'] and e['name'] not in nodes
                and _inside((e['tid'], e['ts'], e['ts'] + e['dur']), [r])}
               for r in ranges[name]]
        bwd = [{e['args']['Sequence number'] for e in backward
                if _inside((e['tid'], e['ts'], e['ts'] + e['dur']), [r])}
               for r in ranges[name + '.backward']]
        assert len(bwd) == calls and all(bwd), (name, bwd)
        ran = {e['args']['Sequence number'] for e in backward}
        for b in bwd:
            assert any(b == f & ran for f in fwd), (name, b, fwd)
    snap = tracing.snapshot()
    assert snap['counts'] == {'lstm.frames': frames[0]}
    spans = snap['spans']
    assert spans['step']['calls'] == 1 and spans['cell']['calls'] == 2
    for s in spans.values():
        assert 0 <= s['self_ns'] <= s['ns']
    for parent, children in TRAIN_SPANS.items():
        assert spans[parent]['self_ns'] == spans[parent]['ns'] - sum(
            spans[c]['ns'] for c in children), parent


def test_outputs_bit_equal_on_and_off():
    def run(on):
        tr, loaders = _trainer()
        tr.init_state(_model())
        batch = _batch(loaders)
        logits = []
        hook = tr.model.register_forward_hook(
            lambda m, a, out: logits.append(out.detach().clone()))
        with tracing.enabled() if on else contextlib.nullcontext():
            grads, loss = tr.gradients(batch)
            hook.remove()
            tr.step(batch)
            served = _serve(tr.model.eval(), *_audio())
        return (logits[0], grads, loss, dict(tr.model.named_parameters()),
                served)

    off, on = run(False), run(True)
    assert torch.equal(off[0], on[0])
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    assert off[2] == on[2]
    for k in off[3]:
        assert torch.equal(off[3][k], on[3][k]), k
    assert torch.equal(off[4][0], on[4][0]) and off[4][1] == on[4][1]
    spans = tracing.snapshot()['spans']
    assert {'serve.push', 'serve.flush', 'serve.frontend',
            'serve.device_step', 'serve.decode'} <= set(spans)
    assert 'serve.dequant' not in spans        # quantize=False


def test_serving_spans_nest(tmp_path):
    model = _model().eval()
    with tracing.enabled(), torch.no_grad(), \
            profile(activities=[ProfilerActivity.CPU],
                    record_shapes=True) as prof:
        _serve(model, *_audio())
        q = StreamingASR(model, chunk_frames=16, batch_size=1, quantize=True,
                         device='cpu')
        q.push(np.zeros(4000, np.float32))
        q.flush()
    ranges = _ranges(_events(prof, tmp_path))
    calls = ranges['serve.push'] + ranges['serve.flush']
    assert sorted(r[3]['id'] for r in calls) == [0, 0, 1, 1]
    for child in ('serve.frontend', 'serve.device_step'):
        assert all(_inside(r, calls) for r in ranges[child]), child
    assert all(_inside(r, ranges['serve.device_step'])
               for r in ranges['serve.dequant'] + ranges['lstm']
               + ranges['block_conv'] + ranges['cell'])
    assert ranges['serve.dequant'] and ranges['serve.decode']
    assert not _inside(ranges['serve.decode'][0], calls)
    assert 'lstm.backward' not in ranges       # no grad, no backward range


def test_grads_of_parameters_only_leave_no_span_open():
    model = _model().train()
    feats = torch.randn(2, 40, 80)
    with tracing.enabled():
        out = model(feats, torch.tensor([40, 30]),
                    generator=torch.Generator().manual_seed(1))
        torch.autograd.grad(out.sum(), [model.lstm.kernel])
        with tracing.span('after'):
            pass
    spans = tracing.snapshot()['spans']
    assert spans['after']['calls'] == 1
    assert tracing._stack() == []


def test_profile_dir_trace_holds_the_programs_ranges(tmp_path):
    tr, loaders = _trainer(profile_dir=tmp_path / 'prof', profile_steps=1)
    assert loaders[1].steps >= 2
    tr.train(_model(), epochs=1, lr=1e-3)
    assert not tracing.is_enabled()
    (path,) = (tmp_path / 'prof').glob('*.pt.trace.json')
    names = {e['name'] for e in json.loads(path.read_text())['traceEvents']}
    assert {'nbasr.step', 'nbasr.loader.batch', 'nbasr.step.backward',
            'nbasr.lstm', 'nbasr.lstm.backward', 'nbasr.ctc.forward',
            'nbasr.step.norm_read'} <= names


def test_lstm_backward_range_holds_the_recurrence_function(tmp_path):
    """The recurrence's autograd Function (ops.lstm_recurrence) runs its
    backward, and the input projection's after it, inside
    ``lstm.backward``; its forward inside ``lstm``."""
    model = _model().train()
    feats = torch.randn(2, 40, 80)
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model(feats, torch.tensor([40, 30]),
                    generator=torch.Generator().manual_seed(1))
        out.sum().backward()
    events = _events(prof, tmp_path)
    ranges = _ranges(events)
    (fwd,), (bwd,) = ranges['lstm'], ranges['lstm.backward']

    def spans(name):
        return [(e['tid'], e['ts'], e['ts'] + e['dur']) for e in events
                if e['name'] == name]

    (node,) = spans('_RecurrenceBackward')    # the node, not its wrapper
    assert _inside(node, [bwd])
    projection = [s for s in spans('MmBackward0') if s[1] > node[2]]
    assert projection and all(_inside(s, [bwd]) for s in projection)
    (call,) = spans('_Recurrence')
    assert _inside(call, [fwd])


def test_conformer_spans_and_pairs_counter(tmp_path):
    """The Conformer's layers each have a span and a backward span (the
    subsampling's closed by its first kernel's gradient, its input needing
    none), the attention's backward node inside ``conformer.mhsa.backward``,
    and ``mhsa.pairs`` counts H * sum(L^2) a call."""
    from nbasr_torch.models.conformer import get_conformer
    from nbasr_torch.models.asr import logits_length
    model = get_conformer(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64,
                          conv_kernel=4, device='cpu').train()
    feats, fsize = torch.randn(2, 45, 80), torch.tensor([45, 30])
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model(feats, fsize, generator=torch.Generator().manual_seed(1))
        out.sum().backward()
    events = _events(prof, tmp_path)
    ranges = _ranges(events)
    calls = {'conformer.subsample': 1, 'conformer.ffn': 4,
             'conformer.mhsa': 2, 'conformer.conv_module': 2}
    for name, n in calls.items():
        assert len(ranges[name]) == n and len(ranges[name + '.backward']) == n
    nodes = [(e['tid'], e['ts'], e['ts'] + e['dur']) for e in events
             if e['name'] == 'RelposAttentionBackward']
    assert len(nodes) == 2 and all(
        _inside(n, ranges['conformer.mhsa.backward']) for n in nodes)
    lengths = logits_length(fsize, 45, out.shape[1])
    pairs = 2 * int((lengths.long() ** 2).sum())
    assert tracing.snapshot()['counts'] == {'mhsa.pairs': 2 * pairs}


@pytest.mark.parametrize('dtype,C,counter', [
    (torch.bfloat16, 24, 'cell.linear_mma'),
    (torch.float32, 24, 'cell.linear_fma'),
    (torch.bfloat16, 20, 'cell.linear_fma'),
], ids=['bf16', 'f32', 'bf16-off-8'])
def test_linear_node_counts_its_path(dtype, C, counter):
    """With tracing on, each call of a cell's linear node counts under the
    path the kernels take for it (fused_cell.linear_plans, here through the
    plain versions' planning on the CPU), once forward and once backward:
    the tensor cores for bf16 at C % 8 == 0, the SIMT kernels for f32 and
    for widths off 8 elements; nothing is counted with tracing off."""
    from nbasr_torch.models.cell import SearchCell
    cell = SearchCell(C, [['linear', 1], ['conv5', 1, 0]], groups=4,
                      dropout_rate=0.2)
    cell.train()
    x = torch.randn((2, 9, C), generator=torch.Generator().manual_seed(0)
                    ).to(dtype).requires_grad_(True)

    def step():
        y = cell(x, generator=torch.Generator().manual_seed(1))
        y.float().sum().backward()
    step()
    assert tracing.snapshot()['counts'] == {}
    with tracing.enabled():
        step()
    assert tracing.snapshot()['counts'] == {counter: 2}
