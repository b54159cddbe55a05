"""Data-dependent fusion partitioning.

The port's copy of ``thunder_tpu/executors/data_dependent_partition.py``
(``Node``, ``Graph``: ``_reachable`` :63, ``merge`` :83, ``dataflow_merge``
:106, ``horizontal_merge`` :125, ``toposorted`` :155; ``fuse_bound_symbols``
:175), over the port's ``core.utils.consumed_vars``/``produced_vars``: a
dataflow ``Graph`` over bound symbols, iterative ``dataflow_merge`` and
``horizontal_merge`` with cycle avoidance, and ``fuse_bound_symbols``
returning ordered groups. The region executor
(:mod:`~thunder_tpu_torch.executors.regionex`) forms its regions with it.

Why not just fuse contiguous runs: an unfusible op in *program order* (a
kernel a ``cuda`` claim launches, an ITEM sync, a COMMENT) does not
necessarily sit on the *dataflow* path between its neighbours — contiguous
grouping would split one legal fusion region into two. Here regions are maximal under dataflow:
two fusible ops land in one group unless merging them would create a cycle
through a non-member (which would make the region's inputs depend on its own
outputs).
"""

from __future__ import annotations

from typing import Callable, Sequence

import heapq

from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.utils import consumed_vars, produced_vars


class Node:
    """A mergeable group of bound symbols (starts as a single bsym)."""

    __slots__ = ("bsyms", "parents", "children", "min_index", "max_index", "order")

    def __init__(self, bsym: BoundSymbol, index: int):
        self.bsyms: list[BoundSymbol] = [bsym]
        self.parents: set[Node] = set()
        self.children: set[Node] = set()
        self.min_index = index
        self.max_index = index
        self.order: dict[int, int] = {id(bsym): index}  # program order of members

    def __repr__(self):
        return f"<Node {[b.sym.name for b in self.bsyms]}>"


class Graph:
    """Dataflow graph over a trace's bound symbols."""

    def __init__(self, bsyms: Sequence[BoundSymbol]):
        self.nodes: list[Node] = [Node(b, i) for i, b in enumerate(bsyms)]
        # the ids of the nodes still in ``nodes``: the merge loops ask it for
        # every pair they look at, where a test against the list would make
        # a large program's partition quadratic in its length
        self._alive: set[int] = {id(n) for n in self.nodes}
        # recursive consumed/produced (like the fusion pass's region-IO
        # computation): a composite whose SUBSYMBOLS read a proxy absent from
        # its top-level args still depends on that proxy's producer
        producer_of: dict[str, Node] = {}
        for n in self.nodes:
            for b in n.bsyms:
                for v in produced_vars(b):
                    producer_of[v.proxy.name] = n
        for n in self.nodes:
            for b in n.bsyms:
                for v in consumed_vars(b):
                    p = producer_of.get(v.proxy.name)
                    if p is not None and p is not n:
                        n.parents.add(p)
                        p.children.add(n)

    def _reachable(self, src: Node, dst: Node, *, skip_direct: bool) -> bool:
        """Is there a path src -> dst (optionally ignoring the direct edge)?

        Pure DFS — no index-based pruning: once nodes merge, a node can be
        entered via a high-program-index member and exited via a low-index
        one, so member-index bounds cannot soundly prune paths (an earlier
        pruned version produced cycles under fuzzing).
        """
        stack = [c for c in src.children if not (skip_direct and c is dst)]
        seen: set[int] = set()
        while stack:
            n = stack.pop()
            if n is dst:
                return True
            if id(n) in seen:
                continue
            seen.add(id(n))
            stack.extend(n.children)
        return False

    def merge(self, a: Node, b: Node) -> Node:
        """Fold ``b`` into ``a`` (bsyms kept in program order)."""
        a.order.update(b.order)
        a.bsyms = sorted(a.bsyms + b.bsyms, key=lambda bs: a.order[id(bs)])
        a.min_index = min(a.min_index, b.min_index)
        a.max_index = max(a.max_index, b.max_index)
        for p in b.parents:
            p.children.discard(b)
            if p is not a:
                p.children.add(a)
                a.parents.add(p)
        for c in b.children:
            c.parents.discard(b)
            if c is not a:
                c.parents.add(a)
                a.children.add(c)
        a.parents.discard(b)
        a.children.discard(b)
        a.parents.discard(a)
        a.children.discard(a)
        self.nodes.remove(b)
        self._alive.discard(id(b))
        return a

    def dataflow_merge(self, can_merge: Callable[[Node, Node], bool]) -> None:
        """Merge producer->consumer pairs until fixpoint.
        A pair is mergeable when ``can_merge`` allows it and no *other* path
        connects them (merging would otherwise create a cycle)."""
        changed = True
        while changed:
            changed = False
            for n in list(self.nodes):
                if id(n) not in self._alive:
                    continue
                for c in sorted(n.children, key=lambda x: x.min_index):
                    if not can_merge(n, c):
                        continue
                    if self._reachable(n, c, skip_direct=True):
                        continue  # indirect path through a non-member: cycle
                    self.merge(n, c)
                    changed = True
                    break

    def horizontal_merge(self, can_merge: Callable[[Node, Node], bool]) -> None:
        """Merge sibling nodes (no path either way) that share a parent or
        are both roots — catches parallel branches that the
        vertical pass cannot join."""
        changed = True
        while changed:
            changed = False
            groups: list[list[Node]] = []
            roots = [n for n in self.nodes if not n.parents]
            if len(roots) > 1:
                groups.append(roots)
            for n in self.nodes:
                if len(n.children) > 1:
                    groups.append(sorted(n.children, key=lambda x: x.min_index))
            for group in groups:
                for i in range(len(group)):
                    for j in range(i + 1, len(group)):
                        a, b = group[i], group[j]
                        if id(a) not in self._alive or id(b) not in self._alive or a is b:
                            continue
                        if not can_merge(a, b):
                            continue
                        if self._reachable(a, b, skip_direct=False) or \
                                self._reachable(b, a, skip_direct=False):
                            continue
                        self.merge(a, b)
                        changed = True
                if changed:
                    break

    def toposorted(self) -> list[Node]:
        """Topological order, stable by minimum original index."""
        indeg = {id(n): len(n.parents) for n in self.nodes}
        ready = [(n.min_index, id(n), n) for n in self.nodes if not n.parents]
        heapq.heapify(ready)
        out: list[Node] = []
        while ready:
            _, _, n = heapq.heappop(ready)
            out.append(n)
            for c in n.children:
                indeg[id(c)] -= 1
                if indeg[id(c)] == 0:
                    heapq.heappush(ready, (c.min_index, id(c), c))
        if len(out) != len(self.nodes):  # pragma: no cover - cycle guard
            raise RuntimeError("partition graph has a cycle")
        return out


def fuse_bound_symbols(bsyms: Sequence[BoundSymbol],
                       fusible: Callable[[BoundSymbol], bool]) -> list[list[BoundSymbol]]:
    """Partition ``bsyms`` into an ordered list of groups: maximal fusible
    regions under dataflow plus singleton groups for unfusible ops. Within
    each group, bsyms keep program order; groups come out topologically
    sorted."""
    g = Graph(bsyms)
    node_fusible = {id(n): fusible(n.bsyms[0]) for n in g.nodes}

    def can_merge(a: Node, b: Node) -> bool:
        # merged nodes only ever contain fusible members, so the per-node
        # flag (cached at creation, AND-ed on merge by construction) suffices
        return node_fusible[id(a)] and node_fusible[id(b)]

    g.dataflow_merge(can_merge)
    g.horizontal_merge(can_merge)
    return [n.bsyms for n in g.toposorted()]
