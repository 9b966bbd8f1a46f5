"""Small host-side utilities, the counterpart of ``grakel_tpu/tools.py``
(the reference's ``grakel.tools`` surface).  numpy and scipy only.
"""

from __future__ import annotations

import heapq
import operator

import numpy as np
from scipy.special import binom

__all__ = ["distribute_samples", "inv_dict", "nested_dict_add",
           "nested_dict_get", "matrix_to_dict", "priority_dict"]


def distribute_samples(n, subsets_size_range, n_samples):
    """Distribute ``n_samples`` across subset sizes with binomial weights
    (reference tools.py:232-270): weights C(n, k) normalized, floored,
    remainder spread from the top size downwards.  Returns
    {size: count > 0}.
    """
    min_ss, max_ss = subsets_size_range[0], subsets_size_range[1]
    maxd = min(max_ss, n)
    w = np.array([binom(n, k) for k in range(min_ss, maxd + 1)], dtype=float)
    w = w / np.sum(w)
    smpls = np.floor(w * n_samples).astype(int)
    ss = smpls.shape[0]
    for r in range(int(n_samples - np.sum(smpls))):
        smpls[(ss - r - 1) % ss] += 1
    return {i + min_ss: smpls[i] for i in range(ss) if smpls[i] > 0}


def inv_dict(d):
    """Invert a dict of hashables to {value: list of keys} (list values
    are keyed as tuples; reference tools.py:154-193)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, list):
            v = tuple(v)
        out.setdefault(v, []).append(k)
    return out


def nested_dict_add(d, value, *keys):
    """Set ``d[k1][k2]...[kn] = value`` creating levels as needed
    (reference tools.py:89-112)."""
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value


def nested_dict_get(d, *keys, default=None):
    """Get ``d[k1][k2]...[kn]`` or ``default``
    (reference tools.py:115-151)."""
    cur = d
    for k in keys:
        if isinstance(cur, dict) and k in cur:
            cur = cur[k]
        else:
            return default
    return cur


_COMPARE = {">": operator.gt, "<": operator.lt, ">=": operator.ge,
            "<=": operator.le, "==": operator.eq}


def matrix_to_dict(matrix, op=">", const_value=0, allow_diagonal=False):
    """Adjacency matrix -> {vertex: set of neighbors} by elementwise
    comparison (reference tools.py:196-229)."""
    opf = _COMPARE[op]
    n = matrix.shape[0]
    out = {}
    for i in range(n):
        line = matrix[i, :]
        out[i] = {j for j in range(n)
                  if (allow_diagonal or j != i) and opf(line[j], const_value)}
    return out


class priority_dict(dict):
    """Dictionary whose ``pop_smallest`` returns the key with the lowest
    value — the reference's Dijkstra queue structure (tools.py:17-86),
    over ``heapq`` with lazy deletion.  Iterating consumes the dict in
    increasing-value order.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._heap = [(v, k) for k, v in self.items()]
        heapq.heapify(self._heap)

    def __setitem__(self, key, val):
        super().__setitem__(key, val)
        heapq.heappush(self._heap, (val, key))

    def smallest(self):
        heap = self._heap
        while heap and (heap[0][1] not in self
                        or self[heap[0][1]] != heap[0][0]):
            heapq.heappop(heap)
        if not heap:
            raise IndexError("smallest of empty priority_dict")
        return heap[0][1]

    def pop_smallest(self):
        k = self.smallest()
        del self[k]
        return k

    def __iter__(self):
        def it():
            while len(self):
                yield self.pop_smallest()
        return it()
