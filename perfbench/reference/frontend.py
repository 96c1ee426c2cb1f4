"""The recipe's log-mel frontend, plain PyTorch: 16 kHz audio, 25 ms
periodic-Hann windows every 10 ms without centring, the power spectrum
of a 400-point real FFT, an HTK-mel filterbank of 80 triangles from 0 to
8 kHz with a zero DC row (``tf.signal.linear_to_mel_weight_matrix``), and
``log(x + 1e-10)``."""

import functools

import numpy as np
import torch

__all__ = ['SAMPLE_RATE', 'WINDOW', 'HOP', 'num_frames', 'log_mel']

SAMPLE_RATE, WINDOW, HOP, MEL_BINS = 16000, 400, 160, 80


def num_frames(num_samples):
    """Frames of ``num_samples`` samples (no padding at the end)."""
    return max((int(num_samples) - WINDOW) // HOP + 1, 0)


@functools.lru_cache(maxsize=2)
def _mel_matrix():
    bins = WINDOW // 2 + 1
    mel = lambda f: 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)
    freqs = mel(np.linspace(0.0, SAMPLE_RATE / 2.0, bins)[1:])[:, None]
    edges = np.linspace(mel(0.0), mel(8000.0), MEL_BINS + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    w = np.maximum(0.0, np.minimum((freqs - lower) / (center - lower),
                                   (upper - freqs) / (upper - center)))
    return np.vstack([np.zeros((1, MEL_BINS)), w]).astype(np.float32)


def log_mel(audio):
    """``[..., samples]`` audio -> ``[..., frames, 80]`` log-mel, in the
    audio's dtype and on its device."""
    n = max((audio.shape[-1] - WINDOW) // HOP + 1, 0)
    idx = (torch.arange(n, device=audio.device)[:, None] * HOP
           + torch.arange(WINDOW, device=audio.device)[None, :])
    frames = audio[..., idx]
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(WINDOW) / WINDOW)
    frames = frames * torch.as_tensor(hann.astype(np.float32),
                                      device=audio.device).to(audio.dtype)
    power = torch.fft.rfft(frames, n=WINDOW, dim=-1).abs() ** 2
    mel = torch.as_tensor(_mel_matrix(), device=audio.device).to(audio.dtype)
    return torch.log(power @ mel + 1e-10)
