"""Graph connectivity helpers (parity: salve/utils/graph_utils.py).

A copy of salve_tpu/utils/graph_utils.py (no JAX) on the port's graph
helper (utils/graph.py) instead of networkx.
"""

from __future__ import annotations

from typing import Iterable, List, Set, Tuple

import numpy as np

from salve_tpu_torch.utils import graph


def find_connected_components(
    edges: Iterable[Tuple[int, int]], nodes: Iterable[int] = ()
) -> List[Set[int]]:
    """Connected components of an undirected graph, largest first.

    Parity: salve/utils/graph_utils.py — nodes absent from every edge form
    singleton components (they must still count toward the CC distribution).
    """
    G = graph.Graph()
    G.add_nodes_from(nodes)
    G.add_edges_from(edges)
    ccs = list(graph.connected_components(G))
    return sorted(ccs, key=len, reverse=True)


def get_nodes_in_largest_connected_component(
    edges: Iterable[Tuple[int, int]]
) -> List[int]:
    """Node set of the largest connected component."""
    ccs = find_connected_components(edges)
    return list(ccs[0]) if ccs else []


def analyze_cc_distribution(nodes: List[int], edges: List[Tuple[int, int]]):
    """PDF/CDF of connected-component sizes (largest first)."""
    ccs = find_connected_components(edges, nodes=nodes)
    sizes = np.array([len(cc) for cc in ccs], dtype=np.float64)
    n = max(len(nodes), 1)
    pdf = sizes / n
    cdf = np.cumsum(pdf)
    return pdf, cdf
