"""Tiny digraph utilities shared by the static lock-order checker and
the dynamic lock-order recorder: strongly-connected components (iterative
Tarjan — checker input is arbitrary user code, so no recursion limits)
and cycle extraction."""

from __future__ import annotations

from typing import Hashable, Iterable


def strongly_connected_components(
    edges: dict[Hashable, set],
) -> list[list[Hashable]]:
    """Tarjan SCCs over `node -> successor set` (nodes appearing only as
    successors are included)."""
    nodes = set(edges)
    for succs in edges.values():
        nodes |= set(succs)
    index: dict = {}
    lowlink: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list[list] = []
    counter = [0]

    for root in sorted(nodes, key=repr):
        if root in index:
            continue
        # iterative Tarjan: work items are (node, iterator over successors)
        work = [(root, iter(sorted(edges.get(root, ()), key=repr)))]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index:
                    index[succ] = lowlink[succ] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append(
                        (succ, iter(sorted(edges.get(succ, ()), key=repr)))
                    )
                    advanced = True
                    break
                if succ in on_stack:
                    lowlink[node] = min(lowlink[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs


def cyclic_components(edges: dict[Hashable, set]) -> list[list[Hashable]]:
    """SCCs that actually contain a cycle: size > 1, or a self-loop."""
    out = []
    for scc in strongly_connected_components(edges):
        if len(scc) > 1 or (len(scc) == 1 and scc[0] in edges.get(scc[0], ())):
            out.append(sorted(scc, key=repr))
    return out


def edges_from_pairs(pairs: Iterable[tuple]) -> dict:
    edges: dict = {}
    for a, b in pairs:
        edges.setdefault(a, set()).add(b)
    return edges
