"""Training recipe of the port: loss, ratio metrics and the Trainer."""

from .loss import L2_COEFF, conv_l2, get_loss
from .metrics import METRIC_KEYS, accumulate, ratios, zeros_like_metrics
from .trainer import Trainer, get_trainer, lr_at_epoch

__all__ = ['L2_COEFF', 'conv_l2', 'get_loss', 'METRIC_KEYS', 'accumulate',
           'ratios', 'zeros_like_metrics', 'Trainer', 'get_trainer',
           'lr_at_epoch']
