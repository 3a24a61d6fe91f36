"""The port's graph helper (salve_tpu_torch/utils/graph.py) against networkx.

Stage D's poses depend on traversal orders: which shortest path is chained,
which component comes first among equals, which spanning-tree edge a cut is
tried on. So every result is compared as an ordered structure (lists of the
sets' iteration orders, dict item orders, adjacency orders), on graphs that
hypothesis draws with nodes and edges inserted in random orders, isolated
nodes, ties in component size, and subgraphs above and below half the graph
(networkx's subgraph view iterates the induced node set below half).
"""

import networkx as nx
from hypothesis import given, settings
from hypothesis import strategies as st

from salve_tpu_torch.utils import graph
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@st.composite
def graphs(draw, max_nodes=18):
    """(node insertion order, edge list) of a simple undirected graph."""
    n = draw(st.integers(1, max_nodes))
    nodes = draw(st.permutations(list(range(0, 3 * n, 3))))  # sparse ids: set order != sorted order
    pairs = st.tuples(st.sampled_from(nodes), st.sampled_from(nodes)).filter(lambda e: e[0] != e[1])
    edges = draw(st.lists(pairs, max_size=3 * n))
    isolated = draw(st.lists(st.sampled_from(nodes), min_size=1, max_size=n))
    return isolated, edges


def _both(isolated, edges):
    G, H = nx.Graph(), graph.Graph()
    for g in (G, H):
        g.add_nodes_from(isolated)
        g.add_edges_from(edges)
    return G, H


def _same(G, H):
    """Same nodes, adjacency and edges, in the same orders."""
    assert list(G) == list(H) == H.nodes
    assert {n: list(G.adj[n]) for n in G} == {n: H.neighbors(n) for n in H}
    assert [list(G.adj[n]) for n in G] == [H.neighbors(n) for n in H]
    assert list(G.edges()) == H.edges()


def _ccs(g, mod):
    return [list(c) for c in mod.connected_components(g)]


SETTINGS = settings(max_examples=150, deadline=None, derandomize=True)


@SETTINGS
@given(graphs())
def test_construction_copy_and_components(g):
    G, H = _both(*g)
    _same(G, H)
    _same(G.copy(), H.copy())
    assert _ccs(G, nx) == _ccs(H, graph)
    # Ties in size: the first largest, and a stable sort, as Stage D takes them.
    assert list(max(nx.connected_components(G), key=len)) == list(max(graph.connected_components(H), key=len))
    assert [list(c) for c in sorted(nx.connected_components(G), key=len, reverse=True)] == \
        [list(c) for c in sorted(graph.connected_components(H), key=len, reverse=True)]


@SETTINGS
@given(graphs())
def test_single_source_shortest_path(g):
    G, H = _both(*g)
    for source in G:
        want = nx.single_source_shortest_path(G, source)
        got = graph.single_source_shortest_path(H, source)
        assert list(got.items()) == list(want.items())


@SETTINGS
@given(graphs(), st.data())
def test_subgraphs_spanning_trees_and_removals(g, data):
    G, H = _both(*g)
    subsets = [list(c) for c in nx.connected_components(G)]
    subsets.append(data.draw(st.lists(st.sampled_from(list(G)), unique=True)))
    for nodes in subsets:
        Gs, Hs = G.subgraph(nodes), H.subgraph(nodes)
        _same(Gs, Hs)
        _same(Gs.copy(), Hs.copy())
        T, U = nx.minimum_spanning_tree(Gs), graph.minimum_spanning_tree(Hs)
        _same(T, U)
        for e in list(T.edges()):
            T2, U2 = T.copy(), U.copy()
            T2.remove_edge(*e)
            U2.remove_edge(*e)
            _same(T2, U2)
            assert _ccs(T2, nx) == _ccs(U2, graph)
        for v in list(Gs):
            R, S = Gs.copy(), Hs.copy()
            R.remove_node(v)
            S.remove_node(v)
            _same(R, S)
            assert _ccs(R, nx) == _ccs(S, graph)


def test_small_subgraph_iterates_the_induced_set():
    """Below half the graph, networkx iterates the induced node set, whose
    order is not the graph's: the helper follows it."""
    G, H = _both([], [(i, i + 1) for i in range(40)] + [(64, 33), (32, 1)])
    nodes = [40, 33, 64, 32, 1]
    assert 2 * len(nodes) < len(G)
    assert list(G.subgraph(nodes)) == list(H.subgraph(nodes)) == list(set(nodes))
    assert list(G.subgraph(nodes)) != sorted(nodes, key=list(G).index)
    big = list(range(0, 41))
    assert list(G.subgraph(big)) == list(H.subgraph(big)) == [n for n in G if n in set(big)]
