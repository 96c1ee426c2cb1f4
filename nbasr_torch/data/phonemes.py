"""TIMIT phoneme encodings and foldings (p61 / p48 / p39), pure numpy.

The port's own copy of ``nbasr_tpu/data/phonemes.py``.

Re-implements both phoneme-encoder variants of the reference with one class:
``training/tf/datasets/timit_foldings.py`` + ``phoneme_encoder.py`` (p61→p48
encode, blank=0, ids 1..48, `q` dropped) and ``training/torch/encoder.py``
(general N-class encoder with index-level folding for PER-on-p39).

Conventions (identical to the reference):
  - id 0 is reserved for the CTC blank / padding; phoneme ids are 1-based
    indices into the *sorted* phoneme list of the target encoding.
  - folding a sequence maps ids through the p-level tables; ids that fold to
    nothing (only ``q``) are dropped, then zeros are compacted to the right
    (reference ``timit_foldings.py:36-49``).
"""

import numpy as np

from ._folding_table import FOLDING

__all__ = ['PhonemeEncoder', 'fold_ids', 'VOCAB_P48', 'VOCAB_P61', 'VOCAB_P39']

_LEVELS = {61: 0, 48: 1, 39: 2}


def _phoneme_sets():
    sets = [set(), set(), set()]
    for row in FOLDING:
        for level, ph in enumerate(row):
            if ph:
                sets[level].add(ph)
    return [sorted(s) for s in sets]


_PHONEMES = _phoneme_sets()  # sorted p61 / p48 / p39 alphabets
VOCAB_P61, VOCAB_P48, VOCAB_P39 = _PHONEMES


def _fold_map(src_level, dst_level):
    """phoneme(str) at src level -> phoneme(str) or None at dst level."""
    out = {}
    for row in FOLDING:
        src, dst = row[src_level], row[dst_level]
        if src is not None and src not in out:
            out[src] = dst
    return out


def _fold_id_table(src_level, dst_level):
    """Dense int table: src id (0..len) -> dst id (0 if dropped); 0 -> 0."""
    src_ph, dst_ph = _PHONEMES[src_level], _PHONEMES[dst_level]
    fmap = _fold_map(src_level, dst_level)
    table = np.zeros(len(src_ph) + 1, dtype=np.int32)
    for i, ph in enumerate(src_ph):
        dst = fmap.get(ph)
        table[i + 1] = (dst_ph.index(dst) + 1) if dst else 0
    return table


# Precomputed id-level folding tables keyed by (src_classes, dst_classes).
_ID_TABLES = {
    (a, b): _fold_id_table(_LEVELS[a], _LEVELS[b])
    for a in (61, 48) for b in (48, 39) if _LEVELS[a] < _LEVELS[b]
}


def fold_ids(ids, src_classes, dst_classes, compact=True):
    """Fold id sequences between encodings; 0 stays 0 (blank/pad).

    ``ids`` is any integer ndarray; ids that fold to nothing become 0 and,
    when ``compact`` (the default, matching reference
    ``timit_foldings.py:36-49``), surviving ids are shifted left with zeros
    padded on the right, per row.
    """
    if src_classes == dst_classes:
        return np.asarray(ids, dtype=np.int32)
    table = _ID_TABLES[(src_classes, dst_classes)]
    ids = np.asarray(ids)
    folded = table[ids]
    if not compact:
        return folded
    out = np.zeros_like(folded)
    flat = out.reshape(-1, out.shape[-1]) if out.ndim > 1 else out[None, :]
    src = folded.reshape(flat.shape)
    for r in range(flat.shape[0]):
        keep = src[r][src[r] > 0]
        flat[r, :len(keep)] = keep
    return out if out.ndim > 1 else flat[0]


class PhonemeEncoder:
    """Encode phoneme-string sequences to 1-based ids at a folding level.

    ``PhonemeEncoder(48)`` reproduces the reference's canonical TF encoder:
    raw p61 transcripts are folded to p48 at encode time, ``q`` dropped,
    vocab_size = 49 (48 phonemes + blank 0).
    """

    all_encodings = (61, 48, 39)

    def __init__(self, num_classes=48):
        if num_classes not in self.all_encodings:
            raise ValueError(f'num_classes must be one of {self.all_encodings}')
        self.num_classes = num_classes
        self.level = _LEVELS[num_classes]
        self.phonemes = _PHONEMES[self.level]
        self._p61_to_own = _fold_map(0, self.level) if self.level else None
        #: vocab_size counts the blank (reference phoneme_encoder.py:20).
        self.vocab_size = len(self.phonemes) + 1

    def get_vocab(self, inc_blank=False, num_classes=None):
        """Phoneme list, optionally with a leading blank symbol '_'."""
        level = _LEVELS[num_classes] if num_classes is not None else self.level
        vocab = list(_PHONEMES[level])
        return (['_'] + vocab) if inc_blank else vocab

    def encode(self, phonemes):
        """p61 phoneme strings -> ids in [1, vocab_size); dropped fold -> skipped."""
        ids = []
        for ph in phonemes:
            if isinstance(ph, bytes):
                ph = ph.decode('utf-8')
            if self._p61_to_own is not None:
                if ph not in self._p61_to_own:
                    raise KeyError(f'{ph!r} is not a TIMIT p61 phoneme')
                ph = self._p61_to_own[ph]
                if ph is None:  # `q` folds to nothing
                    continue
            ids.append(self.phonemes.index(ph) + 1)
        return ids

    def decode(self, ids):
        """ids -> phoneme strings; 0 decodes to '' (pad/blank)."""
        return [self.phonemes[i - 1] if i else '' for i in ids]

    def decode_to_sentence(self, ids):
        """ids -> space-joined phoneme string (for WER-style metrics)."""
        return ' '.join(p for p in self.decode(ids) if p)

    def fold_encoded(self, ids, num_classes, compact=True):
        """Remap already-encoded ids to a smaller encoding (e.g. 48 -> 39)."""
        if num_classes >= self.num_classes:
            return np.asarray(ids, dtype=np.int32)
        return fold_ids(ids, self.num_classes, num_classes, compact=compact)

    # id-table accessor for on-device (gather) folding
    def fold_table(self, num_classes):
        """Dense numpy lookup table own-ids -> target-ids (0 -> 0)."""
        if num_classes == self.num_classes:
            return np.arange(self.vocab_size, dtype=np.int32)
        return _ID_TABLES[(self.num_classes, num_classes)]
