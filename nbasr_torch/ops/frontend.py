"""Audio frontend: framing → Hann → power spectrum → mel → log, PyTorch.

Counterpart of ``nbasr_tpu/ops/frontend.py``: the 80-bin log-mel
filterbank at 16 kHz with a 25 ms window / 10 ms hop, no centring, a
periodic Hann window, the power spectrum, an HTK mel scale with a zero DC
row and fmax 8 kHz, and ``log(x + 1e-10)``.  Runs on the audio tensor's
device.  Two spectrum paths: ``rfft`` (``torch.fft.rfft``) and ``dft`` (an
explicit real DFT as two matmuls).

The rest of the featurizer library (``:145-245``, the reference's
``audio_feature.py`` dispatcher: spec / spec_dB / mel / pmel / lmel / mfcc,
and the inverse STFT) are plain tensor functions with an explicit
``device``: a tensor input stays on its own device unless ``device`` names
another, an array goes to ``device``, the card by default.
"""

import functools

import numpy as np
import torch

__all__ = ['FrontendConfig', 'mel_weight_matrix', 'num_frames',
           'frame_signal', 'log_mel_spectrogram', 'magnitude_spectrogram',
           'to_db', 'mel_spectrogram', 'power_mel_spectrogram', 'mfcc',
           'get_feature', 'inverse_stft']


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


# ---------------------------------------------------------------------------
# the rest of the featurizer library
# ---------------------------------------------------------------------------

def _placed(x, device, dtype=torch.float32):
    """``x`` as a ``dtype`` tensor on ``device`` (a tensor's own device when
    ``device`` is None, the card for an array)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else 'cuda'
    if not isinstance(x, torch.Tensor):
        x = np.array(x)                # a writable copy of any array
    from ..models.asr import resolve_device
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def magnitude_spectrogram(audio, config=None, exponent=2.0, device=None):
    """[..., samples] -> [..., frames, bins] ``|STFT|**exponent`` (reference
    ``audio_feature.py:131-185``)."""
    config = config or FrontendConfig()
    audio = _placed(audio, device)
    power = _power_spectrum(frame_signal(audio, config.window, config.hop),
                            config)
    if exponent == 2.0:
        return power
    return torch.pow(torch.sqrt(power), exponent)


def to_db(spec, ref_level_db=20.0, min_level_db=-100.0, clip=True,
          device=None):
    """Power/magnitude spectrogram -> normalised dB in [0, 1] (reference
    ``audio_feature.py:36-66``)."""
    spec = _placed(spec, device)
    db = 20.0 * torch.log10(torch.clamp(spec, min=1e-10)) - ref_level_db
    db = db / -min_level_db
    if clip:
        db = torch.clamp(db, -1.0, 0.0) + 1.0
    return db


def mel_spectrogram(audio, config=None, mel_mat=None, exponent=2.0,
                    device=None):
    """Linear-power mel filterbank (reference ``audio_feature.py:299-369``)."""
    config = config or FrontendConfig()
    spec = magnitude_spectrogram(audio, config, exponent, device)
    if mel_mat is None:
        mel_mat = mel_weight_matrix(config.num_mel_bins, config.num_bins,
                                    config.sample_rate, config.lower_hz,
                                    config.upper_hz)
    return spec @ torch.as_tensor(mel_mat, device=spec.device)


def power_mel_spectrogram(audio, config=None, power_coeff=1.0 / 15.0,
                          device=None, **kw):
    """PNCC-style power-law mel (reference ``audio_feature.py:424-456``)."""
    return torch.pow(mel_spectrogram(audio, config, device=device, **kw),
                     power_coeff)


@functools.lru_cache(maxsize=4)
def _dct_matrix(n_in, n_out):
    """Orthonormal DCT-II basis [n_in, n_out] (tf.signal.mfccs semantics)."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    basis = np.cos(np.pi * (2 * n + 1) * k / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[:, 0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mfcc(audio, config=None, num_coeffs=13, device=None, **kw):
    """MFCCs: orthonormal DCT-II of the log-mel filterbank (reference
    ``audio_feature.py:396-421``)."""
    config = config or FrontendConfig()
    lmel = log_mel_spectrogram(_placed(audio, device), config, **kw)
    dct = torch.as_tensor(_dct_matrix(config.num_mel_bins, num_coeffs),
                          device=lmel.device)
    return lmel @ dct


def _log_mel(audio, config, device=None, **kw):
    return log_mel_spectrogram(_placed(audio, device), config, **kw)


def _spec_db(audio, config, device=None, **kw):
    return to_db(magnitude_spectrogram(audio, config, device=device), **kw)


_FEATURES = {'spec': magnitude_spectrogram, 'spec_dB': _spec_db,
             'mel': mel_spectrogram, 'pmel': power_mel_spectrogram,
             'lmel': _log_mel, 'mfcc': mfcc}


def get_feature(audio, config=None, feature_type='lmel', device=None, **kw):
    """Feature dispatcher (reference ``audio_feature.py:458-475``)."""
    if feature_type not in _FEATURES:
        raise NotImplementedError(
            f'Unsupported audio feature type {feature_type!r}')
    return _FEATURES[feature_type](audio, config, device=device, **kw)


def inverse_stft(stft, config=None, length=None, device=None):
    """Complex STFT [..., frames, bins] -> audio, by windowed overlap-add
    with squared-window normalisation (reference ``spec2wav``,
    ``audio_feature.py:247-297``)."""
    config = config or FrontendConfig()
    stft = _placed(stft, device, torch.complex64)
    frames = torch.fft.irfft(stft, n=config.fft_length, dim=-1)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(config.window)
                            / config.window)).astype(np.float32)
    frames = frames[..., :config.window] * torch.as_tensor(
        w, device=frames.device)
    n_frames = frames.shape[-2]
    total = config.window + (n_frames - 1) * config.hop
    idx = (np.arange(n_frames)[:, None] * config.hop
           + np.arange(config.window)[None, :]).reshape(-1)
    flat = frames.reshape(frames.shape[:-2] + (-1,))
    audio = torch.zeros(frames.shape[:-2] + (total,), dtype=torch.float32,
                        device=frames.device)
    audio = audio.index_add(-1, torch.as_tensor(idx, device=frames.device),
                            flat)
    norm = np.zeros(total, np.float32)
    np.add.at(norm, idx, np.tile(w * w, n_frames))
    audio = audio / torch.clamp(torch.as_tensor(norm, device=audio.device),
                                min=1e-8)
    if length is not None:
        if length <= total:
            audio = audio[..., :length]
        else:   # framing dropped a tail shorter than one hop; zero-pad back
            audio = torch.nn.functional.pad(audio, (0, length - total))
    return audio
