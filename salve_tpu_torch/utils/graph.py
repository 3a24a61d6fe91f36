"""A small undirected graph with networkx 3.x's results and orders.

Stage D's pose chaining and cluster rescue (utils/graph_utils.py,
algorithms/spanning_tree.py, algorithms/cluster_merging.py) are decided by
traversal orders: which shortest path is chained, which component comes
first among equals, which spanning-tree edges a cut is tried on. salve_tpu
takes those orders from networkx, which the port does not depend on, so this
module repeats the calls Stage D makes with the same operations on the same
dict and set types:

  * `Graph`: nodes and adjacency in insertion order (`add_nodes_from`,
    `add_edges_from`, `copy`, `remove_edge`, `remove_node`, `edges`);
  * `Graph.subgraph`: the induced graph, its nodes in the order of
    networkx's subgraph view, which iterates the induced node *set* when it
    holds fewer than half the graph's nodes and the graph's own order
    otherwise (networkx/classes/coreviews.py:FilterAtlas.__iter__);
  * `connected_components`: a level BFS per unseen node in node order,
    each component a set filled in BFS order (so a set iterates as
    networkx's does);
  * `single_source_shortest_path`: a level BFS in adjacency order;
  * `minimum_spanning_tree` on unit weights: Kruskal over `edges()` in order
    (a stable sort of equal weights), the tree's nodes in the graph's order.

Edge data are not kept: Stage D's graphs carry none.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Iterator, List, Set, Tuple

Node = Hashable


class Graph:
    """An undirected simple graph: node -> {neighbor: None}, in insertion order."""

    def __init__(self) -> None:
        self._adj: Dict[Node, Dict[Node, None]] = {}

    def __iter__(self) -> Iterator[Node]:
        return iter(self._adj)

    def __len__(self) -> int:
        return len(self._adj)

    def __contains__(self, n) -> bool:
        return n in self._adj

    @property
    def nodes(self) -> List[Node]:
        return list(self._adj)

    def neighbors(self, n: Node) -> List[Node]:
        return list(self._adj[n])

    def add_nodes_from(self, nodes: Iterable[Node]) -> None:
        for n in nodes:
            if n not in self._adj:
                self._adj[n] = {}

    def add_edges_from(self, edges: Iterable[Tuple[Node, Node]]) -> None:
        for u, v in edges:
            if u not in self._adj:
                self._adj[u] = {}
            if v not in self._adj:
                self._adj[v] = {}
            self._adj[u][v] = None
            self._adj[v][u] = None

    def edges(self) -> List[Tuple[Node, Node]]:
        """Each edge once, as networkx's EdgeView iterates them."""
        out, seen = [], set()
        for n, nbrs in self._adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    out.append((n, nbr))
            seen.add(n)
        return out

    def copy(self) -> "Graph":
        """networkx's Graph.copy: the nodes, then every (u, v) of the
        adjacency re-added in order."""
        G = Graph()
        G.add_nodes_from(self._adj)
        G.add_edges_from((u, v) for u, nbrs in self._adj.items() for v in nbrs)
        return G

    def subgraph(self, nodes: Iterable[Node]) -> "Graph":
        """The induced subgraph, materialized in the order of networkx's view."""
        induced = set(n for n in nodes if n in self._adj)
        if 2 * len(induced) < len(self._adj):
            order = [n for n in induced if n in self._adj]
        else:
            order = [n for n in self._adj if n in induced]
        G = Graph()
        for n in order:
            G._adj[n] = {v: None for v in self._adj[n] if v in induced}
        return G

    def remove_edge(self, u: Node, v: Node) -> None:
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def remove_node(self, n: Node) -> None:
        for u in list(self._adj[n]):
            del self._adj[u][n]
        del self._adj[n]


def _plain_bfs(G: Graph, n: int, source: Node) -> Set[Node]:
    adj = G._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(G: Graph) -> Iterator[Set[Node]]:
    """Components in node order, each a set filled in BFS order."""
    seen: Set[Node] = set()
    n = len(G)
    for v in G:
        if v not in seen:
            c = _plain_bfs(G, n - len(seen), v)
            seen.update(c)
            yield c


def single_source_shortest_path(G: Graph, source: Node) -> Dict[Node, List[Node]]:
    """node -> the first shortest path from `source` a level BFS finds."""
    if source not in G:
        raise KeyError(f"Source {source} not in G")
    adj = G._adj
    paths = {source: [source]}
    nextlevel = [source]
    n = len(adj)
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in paths:
                    paths[w] = paths[v] + [w]
                    nextlevel.append(w)
            if len(paths) == n:
                return dict(paths)
    return dict(paths)


def minimum_spanning_tree(G: Graph) -> Graph:
    """Kruskal on unit weights: every edge of `edges()` that joins two trees."""
    parent: Dict[Node, Node] = {}

    def root(x: Node) -> Node:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    T = Graph()
    T.add_nodes_from(G)
    for u, v in G.edges():
        ru, rv = root(u), root(v)
        if ru != rv:
            T.add_edges_from([(u, v)])
            parent[ru] = rv
    return T
