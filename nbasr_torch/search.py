"""NAS algorithms over the benchmark: random search, regularized evolution,
zero-cost-proxy ranking.

Own copy of ``nbasr_tpu/search.py`` (the port imports nothing from the JAX
package).  Each search consumes an *evaluator* — any callable ``arch ->
float`` where lower is better — so the same algorithm runs against a
:class:`nbasr_torch.dataset.Dataset` (tabular lookup), a live trainer, or
a zero-cost proxy.

All algorithms are deterministic under ``seed`` (Python's ``random`` and
numpy's ``RandomState``, drawn as the JAX package draws them, so one seed
gives the same history in both) and return a :class:`SearchResult` with
the full evaluation history (arch, score, step).
"""

import dataclasses
import random as _random

from .search_space import (
    get_model_hash, get_random_architectures, get_search_space,
)
from .utils import flatten, copy_structure

__all__ = ['SearchResult', 'random_search', 'regularized_evolution',
           'proxy_search', 'dataset_evaluator']


@dataclasses.dataclass
class SearchResult:
    best_arch: list
    best_score: float
    history: list  # [(step, arch, score)]

    @property
    def num_evaluations(self):
        return len(self.history)

    def best_at(self, step):
        """Best score among the first ``step`` evaluations (anytime curve)."""
        return min(s for t, _, s in self.history[:step])


def dataset_evaluator(dataset, epoch=None, best=True, seed=None):
    """arch -> val PER from a tabular :class:`Dataset` (lower is better).

    Unknown archs score +inf (shouldn't happen for full datasets).
    """
    def evaluate(arch):
        val = dataset.val_acc(arch, epoch=epoch, best=best, seed=seed)
        return float('inf') if val is None else float(val)
    return evaluate


def random_search(evaluator, iterations=100, seed=0, dedup=True):
    """Uniform random sampling; the paper's RS baseline."""
    rng = _random.Random(seed)
    seen = set()
    history = []
    step = 0
    while step < iterations:
        arch = get_random_architectures(1, seed=rng.randrange(1 << 30))[0]
        if dedup:
            h = get_model_hash(arch)
            if h in seen:
                continue
            seen.add(h)
        score = evaluator(arch)
        history.append((step, arch, score))
        step += 1
    best = min(history, key=lambda t: t[2])
    return SearchResult(best[1], best[2], history)


def _mutate(arch, rng, ops=None, nodes=None):
    """Flip one random position of the arch vector to a different value."""
    space = get_search_space(ops, nodes)
    flat_arch = flatten(arch)
    radixes = flatten(space)
    pos = rng.randrange(len(flat_arch))
    choices = [v for v in range(radixes[pos]) if v != flat_arch[pos]]
    flat_arch[pos] = rng.choice(choices)
    return copy_structure(flat_arch, space)


def regularized_evolution(evaluator, iterations=100, population_size=20,
                          sample_size=5, seed=0):
    """Regularized (aging) evolution (Real et al. 2019): tournament-select a
    parent from a random sample, mutate, kill the oldest member."""
    rng = _random.Random(seed)
    population = []  # list of (arch, score), oldest first
    history = []
    for step in range(iterations):
        if len(population) < population_size:
            arch = get_random_architectures(1, seed=rng.randrange(1 << 30))[0]
        else:
            sample = rng.sample(population, sample_size)
            parent = min(sample, key=lambda t: t[1])[0]
            arch = _mutate(parent, rng)
        score = evaluator(arch)
        population.append((arch, score))
        history.append((step, arch, score))
        if len(population) > population_size:
            population.pop(0)  # age out the oldest
    best = min(history, key=lambda t: t[2])
    return SearchResult(best[1], best[2], history)


def proxy_search(proxy_name, candidates=None, num_candidates=50, seed=0,
                 batch=None, top_k=5, device='cuda', **proxy_kwargs):
    """Rank random candidates by a zero-cost proxy (higher proxy = better).

    Returns the top-k archs with their proxy scores — the cheap first stage
    of a proxy-then-train pipeline.  ``batch`` is (features, feature_size,
    labels, label_size); a synthetic batch is generated when omitted.  The
    proxies run on ``device``, the card unless the caller asks for the CPU.
    """
    import numpy as np
    from .models.proxies import compute_proxy

    if candidates is None:
        candidates = get_random_architectures(num_candidates, seed=seed)
    if batch is None:
        rng = np.random.RandomState(seed)
        batch = (rng.randn(1, 64, 80).astype(np.float32),
                 np.asarray([64], np.int32),
                 rng.randint(1, 49, size=(1, 6)).astype(np.int32),
                 np.asarray([6], np.int32))
    feats, fsize, labels, lsize = batch
    scored = []
    for arch in candidates:
        score = compute_proxy(proxy_name, arch, feats, fsize, labels, lsize,
                              device=device, **proxy_kwargs)
        scored.append((arch, score))
    scored.sort(key=lambda t: -t[1])
    return scored[:top_k]
