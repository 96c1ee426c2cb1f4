"""Architecture graphs: construction, minimisation, isomorphism-invariant hashing.

Own copy of ``nbasr_tpu/graph_utils.py`` (the port imports nothing from
the JAX package), after the reference's ``nasbench_asr/graph_utils.py``.
The hash must be *bit-identical* to the reference (it keys the released
pickle datasets), so the hashing scheme follows the same NASBench-101-style
algorithm: per-vertex MD5 fingerprints of (out-degree, in-degree, label),
iteratively mixed with sorted neighbour fingerprints for |V| rounds, then an
MD5 over the sorted final fingerprints (reference ``graph_utils.py:145-180``).
The numpy path below is the canonical one; ``networkx`` is imported only by
the cross-check functions that use it.

Graph encoding (reference ``graph_utils.py:17-76``): vertices are
``input(0), node_1..node_N, output(N+1)``; each node has a chain edge from
its predecessor, and node ``i``'s skip-branch bits contribute edges into
vertex ``i+2`` (the add at the *next* node's input, which is how the cell's
``op(x) + sum(branches)`` dataflow linearises into a DAG).

The graphviz rendering of the reference (``graph_utils.py:212-314``) is
plain DOT-text emission (:func:`to_dot`, :func:`render`); an image is drawn
only where the ``dot`` binary exists.
"""

import hashlib
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

from .utils import flatten

__all__ = [
    'get_model_graph', 'graph_hash', 'get_model_graph_nx', 'graph_hash_nx',
    'to_dot', 'render', 'show_model',
]


def _build_adjacency(arch_vec, ops):
    """Dense (N+2)x(N+2) float adjacency + vertex labels for an arch vector."""
    num_nodes = len(arch_vec)
    size = num_nodes + 2
    mat = np.zeros((size, size))  # float64 on purpose: degree strings feed MD5
    labels = ['input'] + [ops[node[0]] for node in arch_vec] + ['output']

    # Chain edges: vertex v-1 -> v for every node and the output.
    for v in range(1, size):
        mat[v - 1, v] = 1
    # Node i's branch bits [b_0..b_i] add edges src -> i+2.
    for i, node in enumerate(arch_vec):
        dst = i + 2
        for src, bit in enumerate(node[1:]):
            if bit:
                mat[src, dst] = 1
    return mat, labels


def _reachable(mat, src, reverse=False):
    """Boolean reachability from ``src`` following (or reversing) edges."""
    adj = mat.T if reverse else mat
    visited = np.zeros(len(mat), dtype=bool)
    visited[src] = True
    stack = [src]
    while stack:
        v = stack.pop()
        for w in np.nonzero(adj[v])[0]:
            if not visited[w]:
                visited[w] = True
                stack.append(int(w))
    return visited


def _minimize(mat, labels, keep_dims):
    """Drop 'zero' vertices and anything not on an input->output path.

    Mirrors reference ``graph_utils.py:39-76`` (zero-removal + bidirectional
    BFS prune).
    """
    for v, label in enumerate(labels):
        if label == 'zero':
            mat[v, :] = 0
            mat[:, v] = 0
    alive = _reachable(mat, 0) & _reachable(mat, len(mat) - 1, reverse=True)
    dangling = np.nonzero(~alive)[0]
    if dangling.size:
        if keep_dims:
            mat[dangling, :] = 0
            mat[:, dangling] = 0
            for v in dangling:
                labels[v] = None
        else:
            mat = np.delete(mat, dangling, axis=0)
            mat = np.delete(mat, dangling, axis=1)
            labels = [l for v, l in enumerate(labels) if v not in set(dangling.tolist())]
    return mat, labels


def get_model_graph(arch_vec, ops=None, minimize=True, keep_dims=False):
    """arch vector -> ((adjacency, labels), original_or_None).

    If ``minimize``, returns the pruned graph plus the pre-minimisation
    original; otherwise original is ``None``.  Mirrors reference
    ``graph_utils.py:17-76``.
    """
    if ops is None:
        from .search_space import ALL_OPS as ops
    mat, labels = _build_adjacency(arch_vec, ops)
    orig = None
    if minimize:
        orig = (mat.copy(), list(labels))
        mat, labels = _minimize(mat, labels, keep_dims)
    return (mat, labels), orig


def _vertex_fingerprints(mat, labels):
    """Initial per-vertex MD5 of (out-degree, in-degree, label) triples.

    Degrees are float sums over the float adjacency — their ``str()`` forms
    ('1.0') are part of the hash contract with the reference datasets.
    """
    in_deg = np.sum(mat, axis=0).tolist()
    out_deg = np.sum(mat, axis=1).tolist()
    assert len(in_deg) == len(out_deg) == len(labels)
    return [
        hashlib.md5(str(triple).encode('utf-8')).hexdigest()
        for triple in zip(out_deg, in_deg, labels)
    ]


def graph_hash(graph):
    """Isomorphism-invariant MD5 hash of ``(adjacency, labels)``.

    Labels are remapped to canonical op indices with input=-1 / output=-2
    before hashing (reference ``graph_utils.py:177-179``), so the hash is
    independent of op *names* but tied to their canonical order.
    """
    from .search_space import ALL_OPS
    mat, names = graph
    labels = []
    if names:
        labels = [-1] + [ALL_OPS.index(op) for op in names[1:-1]] + [-2]

    n = mat.shape[0]
    fp = _vertex_fingerprints(mat, labels)
    for _ in range(n):
        fp = [
            hashlib.md5((
                ''.join(sorted(fp[w] for w in range(n) if mat[w, v]))
                + '|'
                + ''.join(sorted(fp[w] for w in range(n) if mat[v, w]))
                + '|' + fp[v]
            ).encode('utf-8')).hexdigest()
            for v in range(n)
        ]
    return hashlib.md5(str(sorted(fp)).encode('utf-8')).hexdigest()


# ---------------------------------------------------------------------------
# networkx cross-check path (reference graph_utils.py:78-136,182-183)
# ---------------------------------------------------------------------------

def get_model_graph_nx(arch_vec, ops=None, minimize=True):
    """Build the same graph as a ``networkx.DiGraph`` (for self-checks)."""
    import networkx as nx
    (mat, labels), orig = get_model_graph(arch_vec, ops=ops, minimize=minimize)
    def to_nx(m, ls):
        g = nx.DiGraph()
        for v, l in enumerate(ls):
            g.add_node(v, label=l)
        for src, dst in zip(*np.nonzero(m)):
            g.add_edge(int(src), int(dst))
        return g
    return to_nx(mat, labels), (to_nx(*orig) if orig is not None else None)


def graph_hash_nx(g):
    """Weisfeiler-Lehman hash over node labels (cross-check only)."""
    import networkx as nx
    return nx.algorithms.graph_hashing.weisfeiler_lehman_graph_hash(g, node_attr='label')


# ---------------------------------------------------------------------------
# Visualisation: plain DOT text, no pygraphviz (reference: show_graph/show_model)
# ---------------------------------------------------------------------------

_OP_STYLE = {
    'linear': ('Linear', 'tomato'),
    'conv5': ('Conv(5)', 'cadetblue1'),
    'conv5d2': ('Conv(5,d=2)', 'deepskyblue1'),
    'conv7': ('Conv(7)', 'olivedrab2'),
    'conv7d2': ('Conv(7,d=2)', 'seagreen4'),
    'zero': ('Zero', None),
    'input': ('Input', None),
    'output': ('Output', None),
}


def to_dot(graph):
    """Render ``(adjacency, labels)`` as graphviz DOT text."""
    mat, labels = graph
    lines = ['digraph arch {', '  rankdir=TB;', '  node [shape=box, style=rounded];']
    for v, label in enumerate(labels):
        text, color = _OP_STYLE.get(label, (str(label), None))
        attrs = f'label="{text}"'
        if color:
            attrs += f', style="filled,rounded", fillcolor="{color}"'
        lines.append(f'  n{v} [{attrs}];')
    for src, dst in zip(*np.nonzero(mat)):
        style = '' if dst == src + 1 else ' [style=dashed]'
        lines.append(f'  n{src} -> n{dst}{style};')
    lines.append('}')
    return '\n'.join(lines)


def render(graph, path=None, fmt='png'):
    """Write DOT (and, when the ``dot`` binary exists, an image) for a graph.

    Returns the path of whichever artifact was produced.
    """
    dot_text = to_dot(graph)
    if path is None:
        path = tempfile.mktemp('', 'nbasr_graph.')
    path = pathlib.Path(path)
    # append (not with_suffix: arch ids contain dots-like segments that
    # with_suffix would clobber, collapsing every arch onto one filename)
    dot_path = path.parent / (path.name + '.dot')
    dot_path.write_text(dot_text)
    if shutil.which('dot'):
        img_path = path.parent / (path.name + f'.{fmt}')
        subprocess.run(['dot', f'-T{fmt}', str(dot_path), '-o', str(img_path)], check=True)
        return img_path
    return dot_path


def show_model(arch_vec, aid=None, out_dir=None):
    """Render minimal (and, when different, full) graphs for an arch vector.

    Mirrors reference ``graph_utils.py:301-314`` but never spawns a viewer.
    """
    graph, full = get_model_graph(arch_vec)
    if aid is None:
        aid = '_'.join(map(str, flatten(arch_vec)))
    out_dir = pathlib.Path(out_dir) if out_dir is not None else pathlib.Path('graphs')
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [render(graph, out_dir / f'nb_graph.{aid}')]
    if full is not None and graph_hash(graph) != graph_hash(full):
        paths.append(render(full, out_dir / f'nb_graph.{aid}_full'))
    return paths
