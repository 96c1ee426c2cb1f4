"""TIMIT corpus reading: wav audio (RIFF or NIST SPHERE) + .PHN transcripts.

The port's own copy of ``nbasr_tpu/data/timit.py``, with its C++ parser
(:mod:`nbasr_torch.native`) as the fast path of :func:`read_wav`.
Host-side.  Replaces the reference's TF reader
(``training/tf/datasets/audio_sentence_timit.py``) and torch reader
(``training/torch/timit.py:14-54``) with one implementation that reads
*both* sox-converted ``*.RIFF.WAV`` files and the original NIST SPHERE
``.WAV`` files (the reference required a sox pre-conversion pass;
we parse SPHERE headers directly so no conversion is needed).

Conventions kept from the reference:
  - ``SA*`` dialect sentences are dropped (``audio_sentence_timit.py:97-101``)
  - transcripts come from the last whitespace column of ``.PHN`` lines
    (``audio_sentence_timit.py:49-61``)
"""

import pathlib

import numpy as np

__all__ = ['read_wav', 'read_phn', 'scan_split', 'TimitSplit']


def _parse_sphere(data):
    """NIST SPHERE: 1024*k ASCII header then PCM payload."""
    header_end = data.find(b'end_head')
    if header_end < 0:
        raise ValueError('Malformed SPHERE header')
    header = data[:header_end].decode('ascii', errors='replace')
    fields = {}
    for line in header.splitlines()[1:]:
        parts = line.split()
        if len(parts) >= 3:
            fields[parts[0]] = parts[2]
    header_bytes = int(data[8:16].decode('ascii').strip() or 1024)
    sample_rate = int(fields.get('sample_rate', 16000))
    n_bytes = int(fields.get('sample_n_bytes', 2))
    if n_bytes != 2:
        raise ValueError(f'Unsupported SPHERE sample width: {n_bytes}')
    fmt = fields.get('sample_byte_format', '01')
    dtype = '<i2' if fmt == '01' else '>i2'
    pcm = np.frombuffer(data[header_bytes:], dtype=dtype)
    return pcm.astype(np.float32) / 32768.0, sample_rate


def _parse_riff(data):
    """Minimal RIFF/WAVE PCM16 parser (mono)."""
    if data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise ValueError('Not a RIFF/WAVE file')
    pos = 12
    sample_rate, num_channels, bits = 16000, 1, 16
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], 'little')
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b'fmt ':
            num_channels = int.from_bytes(body[2:4], 'little')
            sample_rate = int.from_bytes(body[4:8], 'little')
            bits = int.from_bytes(body[14:16], 'little')
        elif chunk_id == b'data':
            pcm = body
        pos += 8 + size + (size & 1)
    if pcm is None:
        raise ValueError('RIFF file has no data chunk')
    if bits != 16:
        raise ValueError(f'Unsupported PCM width: {bits}')
    audio = np.frombuffer(pcm, dtype='<i2').astype(np.float32) / 32768.0
    if num_channels > 1:
        audio = audio.reshape(-1, num_channels).mean(axis=1)
    return audio, sample_rate


def read_wav(path, use_native=True):
    """Read a TIMIT wav (RIFF or NIST SPHERE) -> (float32 audio in [-1,1], rate).

    Uses the C++ parser (:mod:`nbasr_torch.native`) where it is built, the
    numpy parser otherwise."""
    data = pathlib.Path(path).read_bytes()
    if use_native:
        from .. import native
        if native.available():
            return native.parse_wav(data)
    if data[:8] == b'NIST_1A\n':
        return _parse_sphere(data)
    return _parse_riff(data)


def read_phn(path):
    """Parse a ``.PHN`` file -> list of p61 phoneme strings (last column)."""
    lines = pathlib.Path(path).read_text().strip().split('\n')
    return [line.rsplit(None, 1)[-1] for line in lines if line.strip()]


def scan_split(root, split, remove_sa=True):
    """Find (wav, phn) file pairs under ``root/split`` recursively.

    Handles both ``X.RIFF.WAV`` (sox-converted; preferred when both exist,
    matching the reference) and plain ``X.WAV``/``X.wav`` NIST files.
    """
    root = pathlib.Path(root).expanduser()
    split_dirs = [p for p in root.rglob(split) if p.is_dir()]
    pairs = {}
    for d in split_dirs:
        for wav in sorted(d.rglob('*')):
            name = wav.name.upper()
            if not (name.endswith('.WAV') and wav.is_file()):
                continue
            stem = wav.name[:-len('.RIFF.WAV')] if name.endswith('.RIFF.WAV') else wav.stem
            if remove_sa and stem.upper().startswith('SA'):
                continue
            phn = wav.parent / f'{stem}.PHN'
            if not phn.exists():
                phn = wav.parent / f'{stem}.phn'
            if not phn.exists():
                continue
            key = str(wav.parent / stem)
            if key not in pairs or name.endswith('.RIFF.WAV'):
                pairs[key] = (wav, phn)
    return [pairs[k] for k in sorted(pairs)]


class TimitSplit:
    """An in-memory TIMIT split: float32 audio + encoded phoneme ids.

    Audio is loaded eagerly (TIMIT is small: ~4h total), matching the torch
    reference (``timit.py:23-28``).
    """

    def __init__(self, root, split, encoder, remove_sa=True):
        self.name = split
        self.audio = []
        self.labels = []
        for wav, phn in scan_split(root, split, remove_sa=remove_sa):
            samples, rate = read_wav(wav)
            if rate != 16000:
                raise ValueError(f'{wav}: expected 16 kHz, got {rate}')
            self.audio.append(samples)
            self.labels.append(np.asarray(encoder.encode(read_phn(phn)), dtype=np.int32))
        if not self.audio:
            raise ValueError(f'No utterances found for split {split!r} under {root}')

    def __len__(self):
        return len(self.audio)
