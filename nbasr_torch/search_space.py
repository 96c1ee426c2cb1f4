"""The part of the NAS-Bench-ASR search space the model factory needs.

Own copy of ``nbasr_tpu/search_space.py`` ``ALL_OPS`` and
``arch_vec_to_names`` (the port imports nothing from the JAX package).  An
arch vector is ``[[op0, b00], [op1, b10, b11], [op2, b20, b21, b22]]``:
``op`` indexes :data:`ALL_OPS`, each ``b`` marks an identity skip branch
(1 = present, the canonical semantics).
"""

__all__ = ['ALL_OPS', 'arch_vec_to_names']

#: Cell operations, in canonical index order (reference search_space.py:6).
ALL_OPS = ['linear', 'conv5', 'conv5d2', 'conv7', 'conv7d2', 'zero']


def arch_vec_to_names(arch_vec, ops=None):
    """Replace op indices in an arch vector with their op names; skip bits
    stay 0/1 (reference search_space.py:77-93)."""
    ops = ops if ops is not None else ALL_OPS
    return [[ops[node[0]]] + list(node[1:]) for node in arch_vec]
