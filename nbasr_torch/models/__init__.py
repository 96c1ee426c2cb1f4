"""Model layer: the NAS-Bench-ASR encoder as PyTorch modules."""

from .asr import ASRModel, count_params, get_model, logits_length
from .cell import SearchCell
from .lstm import FastLSTM

__all__ = ['ASRModel', 'get_model', 'count_params', 'logits_length',
           'SearchCell', 'FastLSTM']
