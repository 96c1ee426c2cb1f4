"""Witness switches, never the main path: inside each context, the port's
kernel wrappers run their plain PyTorch versions on the tensors they are
given, on the card too, so that a run inside differs from the same run
outside in those kernels alone.  No entry point of the port enters them;
checks that hold a kernel against its plain version do.

- :func:`plain_cells`: the fused cell's training forward and backward
  (kernels #1 and #2 under autograd);
- :func:`plain_cell_forward`: the fused cell's no-grad forward (#1 in
  evaluation and serving);
- :func:`plain_convs`: the grouped conv forward, dx and dW (#5-#10);
- :func:`plain_ctc`: the CTC alpha and beta recursions (#3, #4).
"""

import contextlib
import functools

from . import ctc_pallas, fused_cell, grouped_conv

__all__ = ['plain_cells', 'plain_cell_forward', 'plain_convs', 'plain_ctc']


@contextlib.contextmanager
def _patched(module, **fns):
    saved = {n: getattr(module, n) for n in fns}
    for n, fn in fns.items():
        setattr(module, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def plain_cells():
    """Every FusedCell's training forward and backward in their plain
    versions."""
    return _patched(
        fused_cell,
        fused_cell_train_forward=functools.partial(
            fused_cell.fused_cell_reference, save=True),
        fused_cell_backward=fused_cell.fused_cell_backward_reference)


def _reference_launch(spec, x, weights, ln, seed, save=False):
    return (fused_cell.fused_cell_reference(spec, x, weights, ln, seed),)


def plain_cell_forward():
    """The fused cell's no-grad forward in its plain version."""
    return _patched(fused_cell, _launch=_reference_launch)


def plain_convs():
    """Every grouped conv's forward, dx and dW in their plain versions."""
    return _patched(grouped_conv,
                    _launch_forward=grouped_conv.conv_forward_reference,
                    _launch_dx=grouped_conv.conv_dx_reference,
                    _launch_dw=grouped_conv.conv_dw_reference)


def plain_ctc():
    """The CTC loss's alpha and beta recursions in their plain versions."""
    return _patched(ctc_pallas, _launch_alpha=ctc_pallas.alpha_scan_reference,
                    _launch_beta=ctc_pallas.beta_scan_reference)
