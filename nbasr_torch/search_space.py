"""NAS-Bench-ASR search-space definition: ops, encoding, enumeration, sampling.

Own copy of ``nbasr_tpu/search_space.py`` (the port imports nothing from
the JAX package), which re-implements the reference's
``nasbench_asr/search_space.py`` (lines cited per function).  An
architecture ("arch vector") is a nested list

    [[op0, b00], [op1, b10, b11], [op2, b20, b21, b22]]

with one sub-vector per cell node.  ``op`` indexes :data:`ALL_OPS` and each
``b`` is 0/1 marking the presence of an identity skip-connection branch
(1 = skip edge present, the canonical semantics of the graph hash and the
paper).  Sampling draws from Python's ``random`` exactly as the JAX package
does, so one seed gives the same vectors in both.
"""

import random

from .utils import flatten, copy_structure

__all__ = [
    'ALL_OPS', 'OPS_NO_ZERO', 'DEFAULT_NODES',
    'all_ops', 'ops_no_zero', 'default_nodes',
    'get_search_space', 'get_model_hash', 'get_all_architectures',
    'get_random_architectures', 'get_archs_with_zero', 'arch_vec_to_names',
]

#: Cell operations, in canonical index order (reference search_space.py:6).
ALL_OPS = ['linear', 'conv5', 'conv5d2', 'conv7', 'conv7d2', 'zero']
OPS_NO_ZERO = ALL_OPS[:-1]
#: Number of nodes per search cell (reference search_space.py:8).
DEFAULT_NODES = 3

# Aliases matching the reference's public names.
all_ops = ALL_OPS
ops_no_zero = OPS_NO_ZERO
default_nodes = DEFAULT_NODES


def get_search_space(ops=None, nodes=None):
    """Return the per-position cardinalities of the search space.

    For the default setting this is ``[[6, 2], [6, 2, 2], [6, 2, 2, 2]]``.
    Mirrors reference ``search_space.py:11-18``.
    """
    num_ops = len(ops if ops is not None else ALL_OPS)
    num_nodes = nodes if nodes is not None else DEFAULT_NODES
    return [[num_ops] + [2] * (node + 1) for node in range(num_nodes)]


def get_model_hash(arch_vec, ops=None, minimize=True):
    """Graph-isomorphism-invariant hash of an architecture.

    Two arch vectors that minimise to the same computation graph share a
    hash.  Mirrors reference ``search_space.py:21-29``; golden value:
    ``get_model_hash([[1,0],[1,0,0],[1,0,0,0]])
    == '36855332a5778e0df5114305bc3ce238'`` (reference README.md:61).
    """
    from .graph_utils import get_model_graph, graph_hash
    graph, _ = get_model_graph(arch_vec, ops=ops, minimize=minimize)
    return graph_hash(graph)


def get_all_architectures(ops=None, nodes=None):
    """Yield every arch vector in the search space (odometer order).

    13,824 vectors for the default space.  Mirrors reference
    ``search_space.py:32-47``.
    """
    space = get_search_space(ops, nodes)
    radixes = flatten(space)
    digits = [0] * len(radixes)
    done = False
    while not done:
        yield copy_structure(digits, space)
        for pos, radix in enumerate(radixes):
            digits[pos] += 1
            if digits[pos] < radix:
                break
            digits[pos] = 0
            if pos + 1 >= len(radixes):
                done = True


def get_random_architectures(num, ops=None, nodes=None, seed=None):
    """Sample ``num`` arch vectors uniformly (with replacement).

    Mirrors reference ``search_space.py:50-64``.
    """
    space = get_search_space(ops, nodes)
    radixes = flatten(space)
    rng = random.Random(seed) if seed is not None else random
    return [
        copy_structure([rng.randrange(r) for r in radixes], space)
        for _ in range(num)
    ]


def get_archs_with_zero(ops=None, nodes=None):
    """Return one representative arch per unique hash among archs using ``zero``.

    Mirrors reference ``search_space.py:67-74``.
    """
    zero_idx = len(ops if ops is not None else ALL_OPS) - 1
    by_hash = {}
    for arch in get_all_architectures(ops, nodes):
        if zero_idx in flatten(arch):
            by_hash[get_model_hash(arch, ops=ops)] = arch
    return [by_hash[h] for h in sorted(by_hash)]


def arch_vec_to_names(arch_vec, ops=None):
    """Replace op indices in an arch vector with their op names.

    Skip-connection bits are left as 0/1.  Mirrors reference
    ``search_space.py:77-93``.
    """
    ops = ops if ops is not None else ALL_OPS
    return [[ops[node[0]]] + list(node[1:]) for node in arch_vec]
