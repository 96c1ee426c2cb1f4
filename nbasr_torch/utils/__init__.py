"""Utilities of the port: nested-sequence helpers and number formatting,
and the TensorBoard scalar writer (:mod:`.tbwriter`).

Own copy of ``nbasr_tpu/utils/__init__.py`` (the port imports nothing from
the JAX package); each helper mirrors the reference's
``nasbench_asr/utils.py`` function it names.
"""

import collections.abc as _cabc

__all__ = [
    'recursive_iter',
    'flatten',
    'copy_structure',
    'count',
    'get_first_n',
    'make_nice_number',
]


def recursive_iter(seq):
    """Depth-first iterate over all non-sequence leaves of ``seq``.

    Mirrors reference ``nasbench_asr/utils.py:63-71``. Strings are treated
    as leaves (unlike the reference, which would recurse forever on them).
    """
    if isinstance(seq, _cabc.Sequence) and not isinstance(seq, (str, bytes)):
        for item in seq:
            yield from recursive_iter(item)
    else:
        yield seq


def flatten(seq):
    """Flatten arbitrarily nested sequences into a flat list.

    Mirrors reference ``nasbench_asr/utils.py:74-77``.
    """
    return list(recursive_iter(seq))


def copy_structure(data, shape):
    """Unflatten: pour leaves of ``data`` into containers shaped like ``shape``.

    Inverse of :func:`flatten`: ``seq == copy_structure(flatten(seq), seq)``.
    Mirrors reference ``nasbench_asr/utils.py:80-92``.
    """
    leaves = recursive_iter(data)

    def build(template):
        if isinstance(template, _cabc.Sequence) and not isinstance(template, (str, bytes)):
            return type(template)(build(t) for t in template)
        return next(leaves)

    return build(shape)


def count(seq):
    """Count elements of an iterable in a streaming manner.

    Mirrors reference ``nasbench_asr/utils.py:95-101``.
    """
    total = 0
    for _ in seq:
        total += 1
    return total


def get_first_n(seq, n):
    """Yield the first ``n`` elements of ``seq`` (streaming).

    Mirrors reference ``nasbench_asr/utils.py:104-111``.
    """
    it = iter(seq)
    for _ in range(n):
        yield next(it)


def make_nice_number(num):
    """Format an integer with thousands separators (e.g. 26338848 -> '26,338,848').

    Mirrors reference ``nasbench_asr/utils.py:168-175``.
    """
    return f'{int(num):,}'
