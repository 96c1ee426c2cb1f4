"""Audio frontend: framing → Hann → power spectrum → mel → log, PyTorch.

Counterpart of ``nbasr_tpu/ops/frontend.py`` (``:32-136``): the 80-bin
log-mel filterbank at 16 kHz with a 25 ms window / 10 ms hop, no centring,
a periodic Hann window, the power spectrum, an HTK mel scale with a zero
DC row and fmax 8 kHz, and ``log(x + 1e-10)``.  Runs on the audio
tensor's device.  Two spectrum paths: ``rfft`` (``torch.fft.rfft``) and
``dft`` (an explicit real DFT as two matmuls).
"""

import functools

import numpy as np
import torch

__all__ = ['FrontendConfig', 'mel_weight_matrix', 'num_frames',
           'frame_signal', 'log_mel_spectrogram']


class FrontendConfig:
    """Static frontend hyper-parameters (defaults = reference TIMIT recipe)."""

    def __init__(self, sample_rate=16000, window_sec=0.025, hop_sec=0.010,
                 num_mel_bins=80, lower_hz=0.0, upper_hz=8000.0,
                 fft_mode='rfft', log_floor=1e-10):
        self.sample_rate = sample_rate
        self.window = int(window_sec * sample_rate)   # 400
        self.hop = int(hop_sec * sample_rate)         # 160
        self.fft_length = self.window                 # nfft = window (reference)
        self.num_bins = self.fft_length // 2 + 1      # 201
        self.num_mel_bins = num_mel_bins
        self.lower_hz = lower_hz
        self.upper_hz = upper_hz
        self.fft_mode = fft_mode
        self.log_floor = log_floor


def _hertz_to_mel(freq_hz):
    """HTK mel scale used by tf.signal: 1127 * ln(1 + f/700)."""
    return 1127.0 * np.log1p(np.asarray(freq_hz, dtype=np.float64) / 700.0)


def mel_weight_matrix(num_mel_bins=80, num_spectrogram_bins=201,
                      sample_rate=16000, lower_hz=0.0, upper_hz=8000.0,
                      dtype=np.float32):
    """Triangular mel filterbank ``[num_spectrogram_bins, num_mel_bins]``
    identical to ``tf.signal.linear_to_mel_weight_matrix``: the DC row is
    zero, triangles are linear in mel space and unnormalised."""
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_mels = _hertz_to_mel(linear_freqs)[:, None]
    edges = np.linspace(_hertz_to_mel(lower_hz), _hertz_to_mel(upper_hz),
                        num_mel_bins + 2)
    lower_edge, center, upper_edge = edges[:-2], edges[1:-1], edges[2:]
    lower_slopes = (spectrogram_mels - lower_edge) / (center - lower_edge)
    upper_slopes = (upper_edge - spectrogram_mels) / (upper_edge - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.vstack([np.zeros((bands_to_zero, num_mel_bins)), weights]).astype(dtype)


def num_frames(num_samples, config=None):
    """Frame count for ``pad_end=False`` framing; ints, numpy arrays or
    tensors."""
    config = config or FrontendConfig()
    n = (num_samples - config.window) // config.hop + 1
    if isinstance(num_samples, np.ndarray):
        return np.maximum(n, 0)
    if isinstance(num_samples, torch.Tensor):
        return torch.clamp(n, min=0)
    return max(int(n), 0)


def frame_signal(audio, window, hop):
    """[..., samples] -> [..., frames, window] by strided gather."""
    n = max((audio.shape[-1] - window) // hop + 1, 0)
    idx = (torch.arange(n, device=audio.device)[:, None] * hop
           + torch.arange(window, device=audio.device)[None, :])
    return audio[..., idx]


@functools.lru_cache(maxsize=8)
def _dft_matrices(fft_length, num_bins, window):
    """Real-DFT basis (cos, -sin) as [window, num_bins] float32 matrices."""
    k = np.arange(num_bins)[None, :]
    t = np.arange(fft_length)[:, None]
    angle = 2.0 * np.pi * t * k / fft_length
    cos_m = np.cos(angle)[:window].astype(np.float32)
    sin_m = (-np.sin(angle))[:window].astype(np.float32)
    return cos_m, sin_m


def _power_spectrum(frames, config):
    """Windowed power spectrum of [..., frames, window] -> [..., frames, bins]."""
    # periodic Hann, matching tf.signal.hann_window(periodic=True)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(config.window) / config.window)
    frames = frames * torch.as_tensor(w, dtype=frames.dtype, device=frames.device)
    if config.fft_mode == 'dft':
        cos_m, sin_m = (torch.as_tensor(m, device=frames.device) for m in
                        _dft_matrices(config.fft_length, config.num_bins,
                                      config.window))
        re = frames @ cos_m
        im = frames @ sin_m
        return re * re + im * im
    stft = torch.fft.rfft(frames, n=config.fft_length, dim=-1)
    return stft.abs().to(torch.float32) ** 2


def log_mel_spectrogram(audio, config=None, mel_mat=None):
    """[..., samples] float audio -> [..., frames, num_mel_bins] log-mel, on
    the audio tensor's device.  Frames past a padded stream's true end are
    garbage; callers carry the true counts (:func:`num_frames`)."""
    config = config or FrontendConfig()
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if mel_mat is None:
        mel_mat = mel_weight_matrix(
            config.num_mel_bins, config.num_bins, config.sample_rate,
            config.lower_hz, config.upper_hz)
    mel_mat = torch.as_tensor(mel_mat, device=audio.device)
    frames = frame_signal(audio, config.window, config.hop)
    power = _power_spectrum(frames, config)
    return torch.log(power @ mel_mat + config.log_floor)
