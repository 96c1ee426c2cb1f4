"""Model layer: the NAS-Bench-ASR encoder as PyTorch modules."""

from .asr import ASRModel, algorithmic_flops, count_params, get_model, \
    logits_length
from .cell import CELL_DROPOUT, SearchCell
from .lstm import FastLSTM

__all__ = ['ASRModel', 'get_model', 'count_params', 'logits_length',
           'algorithmic_flops', 'SearchCell', 'CELL_DROPOUT', 'FastLSTM']
