"""Minimal ordered DAG for Erg (Encrypted pRocess Graph) construction: the
port's own copy of ``lattisense_tpu/frontend/graph.py``.

Insertion-ordered predecessor/successor lists with edge de-duplication —
the properties the task JSON contract depends on (compute-node input order
selects executor semantics, e.g. 1-input add ⇒ x+x; reference relies on
networkx DiGraph for the same guarantees, frontend/custom_task.py:42).
"""


class Digraph:
    def __init__(self):
        self._preds: dict = {}
        self._succs: dict = {}

    def clear(self):
        self._preds.clear()
        self._succs.clear()

    def add_node(self, u):
        if u not in self._preds:
            self._preds[u] = []
            self._succs[u] = []

    def add_edge(self, u, v):
        self.add_node(u)
        self.add_node(v)
        if v not in self._succs[u]:
            self._succs[u].append(v)
            self._preds[v].append(u)

    def add_edges_from(self, pairs):
        for u, v in pairs:
            self.add_edge(u, v)

    def remove_node(self, u):
        for p in self._preds.pop(u, []):
            self._succs[p].remove(u)
        for s in self._succs.pop(u, []):
            self._preds[s].remove(u)

    def __contains__(self, u):
        return u in self._preds

    def nodes(self):
        return list(self._preds.keys())

    def predecessors(self, u):
        return list(self._preds[u])

    def successors(self, u):
        return list(self._succs[u])

    def topological_sort(self):
        indeg = {u: len(ps) for u, ps in self._preds.items()}
        ready = [u for u, d in indeg.items() if d == 0]
        out = []
        while ready:
            u = ready.pop(0)
            out.append(u)
            for v in self._succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(out) != len(self._preds):
            raise ValueError('graph contains a cycle')
        return out
