"""The port's CTC loss and its recursions against the JAX package on the
CPU, where the port runs the plain versions of its alpha and beta kernels:
the alpha and beta stacks against the JAX Pallas kernels in interpret mode
and against the XLA scans, the forward-only ``ctc_loss_pallas``, the
custom-VJP ``ctc_loss`` (value and gradient, f32 and bf16),
``normalized_ctc_loss``, the alignment posteriors, and ``F.ctc_loss`` as a
third witness.  The rows cover a label_len 0 row, repeated labels (the
skip off), padded frames and an impossible alignment."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from nbasr_tpu.ops import ctc as jctc
from nbasr_tpu.ops import ctc_pallas as jcp

from nbasr_torch.ops import ctc, ctc_pallas

# Finite entries of the stacks, the JAX package's own tolerance for its
# Pallas kernels against its scans (tests/test_ctc_pallas.py:40): the
# recursions sum exp/log terms in the same order, so they differ by the
# libm's ulps, carried over the T steps.
STACK_RTOL, STACK_ATOL = 1e-5, 1e-4
# Losses and gradients in f32, as a share of the largest |JAX| value: the
# log-softmax, the posterior fold (a matmul on both sides) and the
# recursions sum in other orders.
TOL = 1e-5
FLOOR = -1e29


def _case(seed=0):
    """B=6, T=14, V=7, U=5: a full row, repeats (``2 2``, ``6 6``: skip off),
    label_len 0, padded frames (logit_len 9 and 11), and an impossible row
    (five labels in three frames)."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 14, 7) * 2).astype(np.float32)
    logit_len = np.array([14, 9, 14, 3, 11, 14], np.int32)
    labels = np.array([[1, 2, 2, 3, 0], [6, 6, 1, 0, 0], [0, 0, 0, 0, 0],
                       [1, 2, 3, 4, 5], [4, 0, 0, 0, 0], [5, 4, 3, 2, 1]],
                      np.int32)
    label_len = np.array([4, 3, 0, 5, 1, 5], np.int32)
    return logits, logit_len, labels, label_len


IMPOSSIBLE = 3
POSSIBLE = [0, 1, 2, 4, 5]


def _jax_parts(logits, logit_len, labels, label_len):
    """(em, skip_ok, final_states) of the JAX package's helpers."""
    log_probs = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    ext = jctc._extended_labels(jnp.asarray(labels), 0)
    em = jctc._emission_logprobs(log_probs, ext, jnp.asarray(logit_len), 0)
    skip = jctc._transition_masks(ext, 0)
    B, S = ext.shape
    rows, end = jnp.arange(B), 2 * jnp.asarray(label_len)
    final = jnp.zeros((B, S), bool).at[rows, end].set(True)
    final = final.at[rows, jnp.maximum(end - 1, 0)].set(
        jnp.asarray(label_len) > 0)
    return em, skip, final


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _same_stack(got, want):
    """Finite entries within tolerance; the floored ones (<= -1e29, -inf
    included) floored on both sides."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got <= FLOOR, want <= FLOOR)
    finite = want > FLOOR
    np.testing.assert_allclose(got[finite], want[finite], rtol=STACK_RTOL,
                               atol=STACK_ATOL)
    return int(finite.sum()), int((~finite).sum())


def test_helpers_match_jax():
    """Extended labels, emissions (certain blank past logit_len), the skip
    mask and the final states, the last built as the JAX package builds it
    (no final state for a label_len 0 row)."""
    logits, logit_len, labels, label_len = _case()
    em, skip, final = _jax_parts(logits, logit_len, labels, label_len)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    ext = ctc._extended_labels(torch.from_numpy(labels).long(), 0)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(jctc._extended_labels(jnp.asarray(labels), 0)))
    got = ctc._emission_logprobs(lp, ext, torch.from_numpy(logit_len).long(), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(em), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ctc._transition_masks(ext, 0).numpy(),
                                  np.asarray(skip))
    assert not np.asarray(skip)[1, 3] and np.asarray(skip)[0, 3]
    np.testing.assert_array_equal(
        ctc._final_states(torch.from_numpy(label_len).long(), ext.shape[1]
                          ).numpy(), np.asarray(final))
    assert not np.asarray(final)[2].any()


@pytest.mark.parametrize('reference', ['pallas_interpret', 'xla_scan'])
def test_alpha_stack_matches_jax(reference):
    logits, logit_len, labels, label_len = _case(seed=1)
    em, skip, _ = _jax_parts(logits, logit_len, labels, label_len)
    want = (jcp.alpha_scan_pallas(em, skip, interpret=True)
            if reference == 'pallas_interpret' else jctc._alpha_scan(em, skip))
    ctc_pallas.reset_launches()
    got = ctc_pallas.alpha_scan_pallas(*_torch(em, skip))
    assert ctc_pallas.LAUNCHES['alpha'] == {'kernel': 0, 'plain': 1}
    finite, floored = _same_stack(got, want)
    assert finite and floored
    assert np.isneginf(got.numpy()).any()        # log_add(-1e30, -1e30)


@pytest.mark.parametrize('reference', ['pallas_interpret', 'xla_scan'])
def test_beta_stack_matches_jax(reference):
    """The port takes the unshifted skip mask and pre-shifts it, as
    ``beta_scan_pallas`` of the JAX package does."""
    logits, logit_len, labels, label_len = _case(seed=2)
    em, skip, final = _jax_parts(logits, logit_len, labels, label_len)
    want = (jcp.beta_scan_pallas(em, skip, final, interpret=True)
            if reference == 'pallas_interpret'
            else jctc._beta_scan(em, skip, final))
    ctc_pallas.reset_launches()
    got = ctc_pallas.beta_scan_pallas(*_torch(em, skip, final))
    assert ctc_pallas.LAUNCHES['beta'] == {'kernel': 0, 'plain': 1}
    _same_stack(got, want)


def test_ctc_loss_pallas_matches_jax():
    logits, logit_len, labels, label_len = _case(seed=3)
    want = np.asarray(jcp.ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray(logit_len), jnp.asarray(labels),
        jnp.asarray(label_len), interpret=True))
    got = ctc_pallas.ctc_loss_pallas(*_torch(logits, logit_len, labels,
                                             label_len)).numpy()
    assert np.isposinf(want[IMPOSSIBLE]) and np.isposinf(got[IMPOSSIBLE])
    np.testing.assert_allclose(got[POSSIBLE], want[POSSIBLE], rtol=TOL)


def _jax_loss_and_grad(logits, logit_len, labels, label_len, weights,
                       fn=jctc.ctc_loss):
    args = [jnp.asarray(a) for a in (logit_len, labels, label_len)]
    want = np.asarray(fn(jnp.asarray(logits), *args))
    grad = jax.grad(lambda lg: jnp.sum(
        fn(lg, *args).astype(jnp.float32) * weights))(jnp.asarray(logits))
    return want, np.asarray(grad)


def _torch_loss_and_grad(logits, logit_len, labels, label_len, weights,
                         fn=ctc.ctc_loss, dtype=torch.float32):
    lt = torch.tensor(logits).to(dtype).requires_grad_()
    loss = fn(lt, *_torch(logit_len, labels, label_len))
    # the impossible row's +inf would make the sum inf; its weight is 0
    (torch.where(torch.isfinite(loss), loss, 0.0)
     * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), lt.grad.float().numpy()


def test_ctc_loss_value_and_gradient_match_jax():
    """f32, every row: +inf for the impossible one on both sides; its
    gradient NaN in the JAX package and 0 in the port; the label_len 0 row's
    gradient 0 on both sides (no final state)."""
    logits, logit_len, labels, label_len = _case(seed=4)
    weights = np.random.RandomState(5).rand(6).astype(np.float32)
    weights[IMPOSSIBLE] = 0.0
    want, want_grad = _jax_loss_and_grad(logits, logit_len, labels, label_len,
                                         weights)
    got, grad = _torch_loss_and_grad(logits, logit_len, labels, label_len,
                                     weights)
    assert got.dtype == np.float32
    assert np.isposinf(want[IMPOSSIBLE]) and np.isposinf(got[IMPOSSIBLE])
    np.testing.assert_allclose(got[POSSIBLE], want[POSSIBLE], rtol=TOL)
    np.testing.assert_allclose(grad[POSSIBLE], want_grad[POSSIBLE], rtol=0,
                               atol=TOL * np.abs(want_grad[POSSIBLE]).max())
    assert np.isnan(want_grad[IMPOSSIBLE, :logit_len[IMPOSSIBLE]]).all()
    assert not grad[IMPOSSIBLE].any() and not want_grad[2].any()
    assert not grad[1, 9:].any() and not grad[4, 11:].any()


def test_ctc_loss_bf16_logits():
    """bf16 logits.  The port takes the log-softmax in f32 and rounds only
    the gradient, to bf16; the JAX package rounds the log-softmax, the
    emissions and the loss to bf16.  So the port's loss agrees with the JAX
    package's bf16 loss to 2e-2 relative (two bf16 ulps, 2^-8 each, at
    these magnitudes), and its gradient with the JAX f32 gradient on the
    same bf16-valued logits to 2^-8 of the largest gradient (one rounding).
    The JAX bf16 gradient is no yardstick: its posterior divides by the
    bf16-rounded likelihood (up to half a unit off at a loss of ~100, a
    factor of e^0.5), and the JAX model's head gives f32 logits anyway."""
    logits, logit_len, labels, label_len = _case(seed=6)
    logits = np.asarray(jnp.asarray(logits * 8).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    weights = np.ones(6, np.float32)
    weights[IMPOSSIBLE] = 0.0
    want_bf16 = np.asarray(jctc.ctc_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(logit_len),
        jnp.asarray(labels), jnp.asarray(label_len))).astype(np.float32)
    want, want_grad = _jax_loss_and_grad(logits, logit_len, labels, label_len,
                                         weights)
    got, grad = _torch_loss_and_grad(logits, logit_len, labels, label_len,
                                     weights, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[POSSIBLE], want_bf16[POSSIBLE], rtol=2e-2)
    np.testing.assert_allclose(got[POSSIBLE], want[POSSIBLE], rtol=TOL)
    np.testing.assert_allclose(grad[POSSIBLE], want_grad[POSSIBLE], rtol=0,
                               atol=2 ** -8 * np.abs(want_grad[POSSIBLE]).max())
    assert not grad[IMPOSSIBLE].any()


def test_normalized_ctc_loss_zeroes_the_impossible_row():
    """loss / (logit_len + 1); the impossible row's loss is 0 on both sides
    (>= 1e24 gives 0) and its gradient 0 in the port, where the JAX
    package's is NaN; the other rows match."""
    logits, logit_len, labels, label_len = _case(seed=7)
    weights = np.random.RandomState(8).rand(6).astype(np.float32)
    want, want_grad = _jax_loss_and_grad(logits, logit_len, labels, label_len,
                                         weights, fn=jctc.normalized_ctc_loss)
    got, grad = _torch_loss_and_grad(logits, logit_len, labels, label_len,
                                     weights, fn=ctc.normalized_ctc_loss)
    assert got[IMPOSSIBLE] == want[IMPOSSIBLE] == 0.0
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert not grad[IMPOSSIBLE].any()
    assert np.isnan(want_grad[IMPOSSIBLE, :logit_len[IMPOSSIBLE]]).all()
    np.testing.assert_allclose(grad[POSSIBLE], want_grad[POSSIBLE], rtol=0,
                               atol=TOL * np.abs(want_grad[POSSIBLE]).max())


def test_alignment_posteriors_match_jax():
    """Per-frame class posteriors: each valid frame of a possible row with
    labels sums to 1; the impossible row is 0 in the port."""
    logits, logit_len, labels, label_len = _case(seed=9)
    want = np.asarray(jctc.ctc_alignment_posteriors(
        *(jnp.asarray(a) for a in (logits, logit_len, labels, label_len))))
    got = ctc.ctc_alignment_posteriors(
        *_torch(logits, logit_len, labels, label_len)).numpy()
    np.testing.assert_allclose(got[POSSIBLE], want[POSSIBLE], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got[0].sum(-1), 1.0, rtol=1e-5)
    assert not got[IMPOSSIBLE].any()


def test_f_ctc_loss_is_a_third_witness():
    """``F.ctc_loss`` (zero_infinity off) gives the same losses, +inf for
    the impossible row, and the same gradient on every row with labels.  A
    label_len 0 row is where the two differ: the JAX package, and so the
    port, give it no final state and a zero gradient, ``F.ctc_loss`` the
    gradient of the all-blank path."""
    logits, logit_len, labels, label_len = _case(seed=10)
    weights = np.ones(6, np.float32)
    weights[IMPOSSIBLE] = 0.0
    got, grad = _torch_loss_and_grad(logits, logit_len, labels, label_len,
                                     weights)
    lt = torch.tensor(logits, requires_grad=True)
    want = F.ctc_loss(torch.log_softmax(lt, -1).transpose(0, 1),
                      *(t.long() for t in _torch(labels, logit_len,
                                                 label_len)),
                      reduction='none')
    (torch.where(torch.isfinite(want), want, 0.0)
     * torch.from_numpy(weights)).sum().backward()
    want = want.detach().numpy()
    assert np.isposinf(want[IMPOSSIBLE]) and np.isposinf(got[IMPOSSIBLE])
    np.testing.assert_allclose(got[POSSIBLE], want[POSSIBLE], rtol=1e-5)
    labelled = [0, 1, 4, 5]
    np.testing.assert_allclose(grad[labelled], lt.grad.numpy()[labelled],
                               rtol=0, atol=1e-4)
    assert not grad[2].any() and lt.grad[2].abs().max() > 0.1


def test_loss_runs_each_recursion_once_and_refuses_other_devices():
    """One alpha recursion per forward, one beta per backward, none in
    eval; a tensor on neither the CPU nor the card is refused."""
    logits, logit_len, labels, label_len = _case(seed=11)
    lt = torch.tensor(logits, requires_grad=True)
    ctc_pallas.reset_launches()
    with torch.no_grad():
        ctc.normalized_ctc_loss(lt, *_torch(logit_len, labels, label_len))
    assert ctc_pallas.LAUNCHES == {'alpha': {'kernel': 0, 'plain': 1},
                                   'beta': {'kernel': 0, 'plain': 0}}
    ctc.normalized_ctc_loss(lt, *_torch(logit_len, labels, label_len)
                            ).sum().backward()
    assert ctc_pallas.LAUNCHES == {'alpha': {'kernel': 0, 'plain': 2},
                                   'beta': {'kernel': 0, 'plain': 1}}
    em = torch.zeros((3, 2, 5), device='meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        ctc_pallas.alpha_scan_pallas(em, torch.zeros((2, 5), dtype=torch.bool,
                                                     device='meta'))
