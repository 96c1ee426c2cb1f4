"""The port's zero-cost proxies against the JAX package's on the CPU.

The JAX init from ``PRNGKey(seed)`` cannot be drawn in PyTorch, so each
JAX proxy is held against the port's ``_score_<name>`` on a port model that
carries that same init through ``convert.from_flax``.  The JAX cells run
the fused Pallas kernel in interpret mode at the highest matmul precision.

``grad_norm`` and ``snip`` agree within ``RTOL`` (worst reading 2.2e-6 of
the score).  ``synflow`` is held end to end to ``SYNFLOW_RTOL``, and layer
by layer, forward and backward, to ``LAYER_RTOL``: on all-ones input and
|params| without cell norms most pre-activations clip at 20 and the block
LayerNorms see rows that are nearly constant, where they magnify rounding
by up to 1/sqrt(eps) ≈ 32 each.  There the JAX reference is not steady to
1e-4 itself: flax's one-pass variance puts its block LayerNorm 4.1e-3 of
the output's largest value off a float64 two-pass LayerNorm on the same
input (the port's: 5.7e-6), and its gradients up to 1.7e-3 off (the
port's: 1.1e-5), and its own 'fused' and 'chunked' cell paths give
synflow scores 1.3e-2 apart on ``REAL_ARCH`` (readings on these inputs).
Layer by layer, on JAX's own input and output cotangent of each layer,
every other layer of the port is within 3 ulps of JAX, and the block
LayerNorm is held to flax's on rows where the one-pass variance is exact.
"""

import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as nn
import torch

import nbasr_tpu.ops.fused_cell as jax_fused_cell
from nbasr_tpu import search as jax_search
from nbasr_tpu.models import proxies as jax_proxies
from nbasr_tpu.models.asr import get_model as jax_get_model

from nbasr_torch import cli, search
from nbasr_torch.convert import from_flax
from nbasr_torch.models import proxies
from nbasr_torch.models.asr import get_model
from nbasr_torch.models.layers import LayerNorm

TINY_KW = dict(block_filters=(8, 8, 8, 8), cells_per_block=(1, 1, 1, 1),
               cell_groups=2)
REAL_ARCH = [[1, 0], [2, 1, 0], [0, 0, 1, 0]]
ZERO_ARCH = [[5, 0], [5, 0, 0], [5, 0, 0, 0]]
LINEAR_D2_ARCH = [[0, 1], [4, 1, 0], [0, 0, 1, 1]]      # linear + conv7d2
ARCHS = {'real': REAL_ARCH, 'zero': ZERO_ARCH, 'linear+d2': LINEAR_D2_ARCH}
GOLDEN_ARGV = ['1', '0', '1', '0', '0', '1', '0', '0', '0']
RTOL = 1e-4
# above the JAX reference's own 1.3e-2 spread between its cell paths (see
# the module docstring); readings: REAL_ARCH 1.4e-2 (seed 3: 2.1e-3),
# LINEAR_D2_ARCH 6.9e-4, ZERO_ARCH 0 (both scores exactly 0)
SYNFLOW_RTOL = 2e-2
# every layer of the synflow model on JAX's input to it (and, backward,
# JAX's cotangent at its output), relative to the largest value of each
# output or gradient; the block LayerNorms against a float64 two-pass
# LayerNorm.  Readings: the convs, cells and head within 3.4e-7 (3 ulps)
# forward and backward; the LayerNorms' outputs 5.7e-6; their gradients
# (NORM_GRAD_RTOL) 1.1e-5, the input gradient of a row that is nearly
# constant, where the normalisation magnifies f32 rounding
LAYER_RTOL = 1e-5
NORM_GRAD_RTOL = 5e-5


def _batch():
    """The JAX test's batch (``tests/test_proxies.py``)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 32, 80).astype(np.float32)
    fsize = np.array([32, 24], np.int32)
    labels = rng.randint(1, 49, size=(2, 5)).astype(np.int32)
    lsize = np.array([5, 4], np.int32)
    return feats, fsize, labels, lsize


@pytest.fixture(scope='module')
def batch():
    return _batch()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_fused_cell, 'INTERPRET', True)
    with jax.default_matmul_precision('highest'):
        yield


def _model_kwargs(name):
    kw = dict(use_rnn=False, cell_dropout=0.0, init_scheme='scaled', **TINY_KW)
    if name == 'synflow':
        kw['use_norm'] = False
    return kw


def _jax_init(name, arch, feats, fsize, seed):
    model = jax_get_model(arch, grouped_impl='fused', **_model_kwargs(name))
    return model, model.init(jax.random.PRNGKey(seed), feats, fsize)['params']


def _ported(name, arch, params):
    model = get_model(arch, device='cpu', **_model_kwargs(name))
    model.load_state_dict(from_flax({'params': params}))
    return model


def _torch(batch):
    return [torch.from_numpy(a) for a in batch]


# every proxy on every arch at seed 0, and at seed 3 on REAL_ARCH
CASES = [(name, arch, 0) for name in ('grad_norm', 'snip', 'synflow')
         for arch in ARCHS] + [(name, 'real', 3) for name in ('grad_norm',
                                                               'synflow')]


@pytest.mark.parametrize('name,arch,seed', CASES,
                         ids=[f'{n}-{a}-{s}' for n, a, s in CASES])
def test_proxy_matches_jax(name, arch, seed, batch, interpret):
    arch = ARCHS[arch]
    want = jax_proxies.compute_proxy(name, arch, *batch, seed=seed,
                                     grouped_impl='fused', **TINY_KW)
    _, params = _jax_init(name, arch, *batch[:2], seed)
    got = getattr(proxies, f'_score_{name}')(_ported(name, arch, params),
                                             *_torch(batch))
    assert isinstance(got, float) and math.isfinite(got)
    rtol = SYNFLOW_RTOL if name == 'synflow' else RTOL
    assert abs(got - want) <= rtol * abs(want), (got, want)
    if arch == ZERO_ARCH and name != 'grad_norm':
        assert got == want == 0.0     # zero-initialised biases carry it


def _layer_norm64(x, scale, bias, eps):
    """A float64 two-pass LayerNorm of torch tensors."""
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


@functools.lru_cache(maxsize=None)
def _jax_synflow_layers(arch):
    """JAX's synflow pass on the test batch (|params|, all-ones input),
    layer by layer: ``(|params|, the masked input, {layer: output},
    {layer: dR/d output}, {port parameter name: dR/d parameter})``.  The
    cotangents come from a zero added to each layer's output."""
    feats, fsize = _batch()[:2]
    ones = np.ones_like(feats)
    jmodel, params = _jax_init('synflow', ARCHS[arch], ones, fsize, 0)
    params = jax.tree_util.tree_map(jnp.abs, params)
    _, inter = jmodel.apply({'params': params}, ones, fsize,
                            capture_intermediates=True)
    inter = {k: np.array(v['__call__'][0])
             for k, v in inter['intermediates'].items() if k != '__call__'}

    def objective(p, zeros):
        def add_zero(call, args, kwargs, context):
            out = call(*args, **kwargs)
            module = context.module
            if context.method_name == '__call__' and \
                    module.scope.path == (module.name,):
                out = out + zeros[module.name]
            return out

        with nn.intercept_methods(add_zero):
            return jmodel.apply({'params': p}, ones, fsize).sum()

    zeros = {k: jnp.zeros_like(v) for k, v in inter.items()}
    dparams, douts = jax.grad(objective, argnums=(0, 1))(params, zeros)
    mask = np.arange(ones.shape[1])[None, :] < fsize[:, None]
    x = np.where(mask[..., None], ones, 0.0).astype(np.float32)
    return (params, x, inter, {k: np.array(v) for k, v in douts.items()},
            {k: v.numpy() for k, v in from_flax(
                {'params': jax.device_get(dparams)}).items()})


def _layers(model, inter):
    names = [n for n, _ in model.named_children()]
    assert names == [n for n in inter if n in names] and len(names) == 13
    return names


@pytest.mark.parametrize('arch', ['real', 'linear+d2'])
def test_synflow_layers_match_jax(arch, interpret):
    """The synflow forward (|params|, all-ones input), each layer of the
    port on the input JAX gave that layer."""
    params, x, inter, _, _ = _jax_synflow_layers(arch)
    model = _ported('synflow', ARCHS[arch], params)
    for n in _layers(model, inter):
        layer = getattr(model, n)
        with torch.no_grad():
            got = layer(torch.from_numpy(x)).numpy()
        want = inter[n]
        if n.endswith('_norm'):
            want = _layer_norm64(torch.from_numpy(x).double(),
                                 layer.scale.detach().double(),
                                 layer.bias.detach().double(),
                                 layer.epsilon).numpy()
        np.testing.assert_allclose(got, want, rtol=0, err_msg=n,
                                   atol=LAYER_RTOL * np.abs(want).max())
        x = inter[n]


def _vjp(fn, inputs, cotangent):
    """The gradients of ``fn(*inputs)`` against ``cotangent``, numpy."""
    inputs = [t.detach().requires_grad_() for t in inputs]
    grads = torch.autograd.grad(fn(*inputs), inputs, grad_outputs=cotangent)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize('arch', ['real', 'linear+d2'])
def test_synflow_layer_gradients_match_jax(arch, interpret):
    """The synflow backward, each layer of the port on the input and the
    output cotangent JAX gave that layer: the gradient it passes down and
    its parameters' gradients, each against JAX's (the block LayerNorms
    against a float64 LayerNorm's VJP: JAX's one-pass variance reads
    up to 1.7e-3 off it on these nearly constant rows)."""
    params, x, inter, douts, dparams = _jax_synflow_layers(arch)
    model = _ported('synflow', ARCHS[arch], params)
    below = None
    for n in _layers(model, inter):
        layer = getattr(model, n)
        names = [p for p, _ in layer.named_parameters()]
        ct = torch.from_numpy(douts[n])

        def run(xt, *ps):
            return torch.func.functional_call(layer, dict(zip(names, ps)),
                                              (xt,))

        inputs = [torch.from_numpy(x), *layer.parameters()]
        got = _vjp(run, inputs, ct)
        want = [douts[below] if below else None] + [
            dparams[f'{n}.{p}'] for p in names]
        tol = LAYER_RTOL
        if n.endswith('_norm'):
            want = _vjp(lambda xt, scale, bias: _layer_norm64(
                xt, scale, bias, layer.epsilon),
                [t.double() for t in inputs], ct.double())
            tol = NORM_GRAD_RTOL
        for label, g, w in zip(['input'] + names, got, want):
            if w is not None:
                np.testing.assert_allclose(g, w, rtol=0,
                                           err_msg=f'{n} {label}',
                                           atol=tol * np.abs(w).max())
        x, below = inter[n], n


def test_layer_norm_matches_jax():
    """The block LayerNorm, forward and VJP, against flax's on rows where
    its one-pass variance is exact to f32 rounding."""
    rng = np.random.RandomState(7)
    x, ct = rng.randn(2, 2, 32, 8).astype(np.float32)
    scale, bias = rng.randn(2, 8).astype(np.float32)
    jln = nn.LayerNorm(epsilon=1e-3)
    jparams = {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}
    want, vjp = jax.vjp(lambda p, v: jln.apply({'params': p}, v), jparams,
                        jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(ct))
    layer = LayerNorm(8, 1e-3)
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    got = _vjp(lambda xt, s, b: torch.func.functional_call(
        layer, {'scale': s, 'bias': b}, (xt,)),
        [torch.from_numpy(x), layer.scale, layer.bias], torch.from_numpy(ct))
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    for label, g, w in [('output', out, want), ('input', got[0], dx),
                        ('scale', got[1], dp['scale']),
                        ('bias', got[2], dp['bias'])]:
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, err_msg=label,
                                   atol=LAYER_RTOL * np.abs(w).max())


def test_synflow_is_zero_at_full_width(capsys):
    """The full-width flagship on the CLI's batch (B=1, T=128): the
    all-ones input clips every block-1 conv output at 20, the block
    LayerNorm's rows are constant and pass its bias, 0, and nothing after
    it carries the score; the JAX package's CLI prints 0.0 too."""
    cli.main(['proxy', 'synflow', *GOLDEN_ARGV, '--device', 'cpu'])
    assert float(capsys.readouterr().out) == 0.0


@pytest.mark.parametrize('name', sorted(proxies.PROXIES))
def test_proxy_finite_and_deterministic(name, batch):
    a = proxies.compute_proxy(name, REAL_ARCH, *batch, device='cpu',
                              **TINY_KW)
    b = proxies.compute_proxy(name, REAL_ARCH, *_torch(batch), device='cpu',
                              **TINY_KW)
    assert math.isfinite(a) and a == b


@pytest.mark.parametrize('arch', list(ARCHS), ids=list(ARCHS))
def test_num_params_equals_jax(arch, batch):
    arch = ARCHS[arch]
    assert proxies.compute_proxy('num_params', arch, *batch, device='cpu',
                                 **TINY_KW) == \
        jax_proxies.compute_proxy('num_params', arch, *batch, **TINY_KW)


def test_num_params_of_the_flagship(batch):
    # the rnn-free flagship at full width (JAX: tests/test_cli.py)
    assert proxies.compute_proxy('num_params', [[1, 0], [1, 0, 0],
                                                [1, 0, 0, 0]],
                                 *batch, device='cpu') == 22971649.0


def test_synflow_zero_arch_scores_lower(batch):
    feats, fsize = batch[:2]
    real = proxies.compute_proxy('synflow', REAL_ARCH, feats, fsize,
                                 device='cpu', **TINY_KW)
    dead = proxies.compute_proxy('synflow', ZERO_ARCH, feats, fsize,
                                 device='cpu', **TINY_KW)
    assert real > dead


def test_unknown_proxy_raises(batch):
    with pytest.raises(ValueError, match='Unknown proxy'):
        proxies.compute_proxy('nope', REAL_ARCH, *batch[:2], device='cpu')


def test_proxies_default_to_the_card(batch, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        proxies.compute_proxy('grad_norm', REAL_ARCH, *batch, **TINY_KW)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        search.proxy_search('synflow', num_candidates=2, **TINY_KW)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['proxy', 'synflow', *GOLDEN_ARGV])
    assert capsys.readouterr().out == ''


def _recorded_proxy_search(module, target, seed, monkeypatch):
    calls = []

    def record(name, arch, *args, **kwargs):
        calls.append((name, arch, args, kwargs))
        return float(len(calls))

    monkeypatch.setattr(module, 'compute_proxy', record)
    top = target('grad_norm', num_candidates=6, seed=seed, top_k=3)
    return top, calls


@pytest.mark.parametrize('seed', [0, 5])
def test_proxy_search_default_batch_equals_jax(seed, monkeypatch):
    top, calls = _recorded_proxy_search(proxies, search.proxy_search, seed,
                                        monkeypatch)
    jtop, jcalls = _recorded_proxy_search(jax_proxies,
                                          jax_search.proxy_search, seed,
                                          monkeypatch)
    assert top == jtop and len(calls) == len(jcalls) == 6
    for (name, arch, args, kw), (jname, jarch, jargs, jkw) in zip(calls,
                                                                   jcalls):
        assert (name, arch) == (jname, jarch)
        for a, b in zip(args, jargs):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert kw == {**jkw, 'device': 'cuda'}


def test_proxy_search_ranks_by_compute_proxy():
    top = search.proxy_search('synflow', num_candidates=4, seed=1, top_k=3,
                              device='cpu', **TINY_KW)
    rng = np.random.RandomState(1)
    feats = rng.randn(1, 64, 80).astype(np.float32)
    fsize = np.asarray([64], np.int32)
    scored = [(arch, proxies.compute_proxy('synflow', arch, feats, fsize,
                                           device='cpu', **TINY_KW))
              for arch in search.get_random_architectures(4, seed=1)]
    assert top == sorted(scored, key=lambda t: -t[1])[:3]


def test_cli_proxy_on_the_cpu(capsys):
    cli.main(['proxy', 'grad_norm', *GOLDEN_ARGV, '--frames', '64',
              '--device', 'cpu'])
    score = float(capsys.readouterr().out)
    assert math.isfinite(score) and score > 0
