"""Architectures, each the one module ``archs/<model>.py`` that a
configuration names by its ``model`` key.  The harness knows a model only
through the module's functions:

- ``build(cfg, mix, device)``: the program's module through the port's own
  factory (the only function that imports the program);
- ``param_table(cfg)``: ``[(name, shape, std, offset)]`` of every parameter,
  from which :mod:`perfbench.weights` draws the run's weights;
- ``forward(p, cfg, feats, feature_size, stats, gen, rnd, lstm_rate)``: the
  plain float32 reference encoder, the benchmark's own copy;
- ``regularised(name)``: whether the recipe's L2 takes the leaf;
- ``algorithmic_flops(cfg, batch, frames, train)``: FLOPs of one step;
- ``output_stride(cfg)`` and ``halo(cfg)``: input frames a logit frame, and
  the input frames of context the encoder takes on each side.
"""

import importlib
import types

__all__ = ['find']


def find(cfg):
    """The architecture module that ``cfg`` names by its ``model``; a module
    given there in place of a name (a test's) is taken as it is."""
    model = cfg['model']
    if isinstance(model, types.ModuleType):
        return model
    return importlib.import_module(f'{__name__}.{model}')
