"""Connected components of a graph over integer node ids, in numpy.

Counterpart of colmap_tpu/utils/native.py ``union_find_labels`` (l.70-95),
which runs a C++ union-find when its native library loads and a Python one
otherwise. Callers use only the partition: which nodes share a label, not
the label values. Here the components come from hooking and pointer
jumping over the whole edge list at once, and each node's label is the
smallest node id of its component.
"""

from __future__ import annotations

import numpy as np


def union_find_labels(num_nodes: int, edges_a: np.ndarray, edges_b: np.ndarray) -> np.ndarray:
    """(num_nodes,) int64 label per node: the smallest node id of its
    connected component under the undirected edges (edges_a[k], edges_b[k])."""
    a = np.ascontiguousarray(edges_a, dtype=np.int64)
    b = np.ascontiguousarray(edges_b, dtype=np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    while True:
        la, lb = labels[a], labels[b]
        lo = np.minimum(la, lb)
        if np.array_equal(la, lb):
            return labels
        # Hook each root onto the smallest label it meets, then jump pointers
        # until every node points at a root.
        np.minimum.at(labels, la, lo)
        np.minimum.at(labels, lb, lo)
        while True:
            nxt = labels[labels]
            if np.array_equal(nxt, labels):
                break
            labels = nxt
