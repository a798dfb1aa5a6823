# A copy of src/repro/core/planning_graph.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Planning-graph abstraction (§4.1).

The target model is a DAG ``G_M = (V_M, E_M)`` whose nodes are one or
more layers, annotated with per-sample compute/communication costs.
Adjacent nodes whose combined parameter share is below ``delta`` are
merged (lightweight compression), and the DAG is serial-decomposed into
an ordered list of *chains* that the partitioner's DP consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class LayerNode:
    """One (merged) model layer.

    Costs are *per sample* at the workload's sequence length so that a
    stage processing a microbatch of ``b`` samples costs ``b ×`` these.
    """

    name: str
    flops_fwd: float            # forward FLOPs per sample
    param_bytes: float          # parameter bytes (model state on the stage)
    act_bytes: float            # output-activation bytes per sample
    flops_bwd: Optional[float] = None   # defaults to 2 × fwd (dL/dx + dL/dw)
    state_bytes: float = 0.0    # recurrent/KV state bytes per sample (serving)

    def __post_init__(self) -> None:
        if self.flops_bwd is None:
            self.flops_bwd = 2.0 * self.flops_fwd

    def merged_with(self, other: "LayerNode") -> "LayerNode":
        return LayerNode(
            name=f"{self.name}+{other.name}",
            flops_fwd=self.flops_fwd + other.flops_fwd,
            param_bytes=self.param_bytes + other.param_bytes,
            act_bytes=other.act_bytes,       # boundary activation = last node's
            flops_bwd=self.flops_bwd + other.flops_bwd,
            state_bytes=self.state_bytes + other.state_bytes,
        )


class ModelGraph:
    """DAG of LayerNodes. Edges by node index."""

    def __init__(self, nodes: Sequence[LayerNode],
                 edges: Iterable[Tuple[int, int]]):
        self.nodes = list(nodes)
        self.edges = sorted(set(edges))
        n = len(self.nodes)
        for a, b in self.edges:
            if not (0 <= a < n and 0 <= b < n):
                raise ValueError(f"edge ({a},{b}) out of range")
        self._succ: Dict[int, List[int]] = {i: [] for i in range(n)}
        self._pred: Dict[int, List[int]] = {i: [] for i in range(n)}
        for a, b in self.edges:
            self._succ[a].append(b)
            self._pred[b].append(a)
        self._check_acyclic()

    # -- basics ----------------------------------------------------------------
    @classmethod
    def chain(cls, nodes: Sequence[LayerNode]) -> "ModelGraph":
        return cls(nodes, [(i, i + 1) for i in range(len(nodes) - 1)])

    def _check_acyclic(self) -> None:
        order = self.topological_order()
        if len(order) != len(self.nodes):
            raise ValueError("planning graph has a cycle")

    def topological_order(self) -> List[int]:
        indeg = {i: len(self._pred[i]) for i in range(len(self.nodes))}
        ready = sorted(i for i, d in indeg.items() if d == 0)
        out: List[int] = []
        while ready:
            i = ready.pop(0)
            out.append(i)
            for j in self._succ[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
            ready.sort()
        return out

    @property
    def total_params(self) -> float:
        return sum(n.param_bytes for n in self.nodes)

    @property
    def total_flops_fwd(self) -> float:
        return sum(n.flops_fwd for n in self.nodes)

    # -- Δ-compression (§4.1) ----------------------------------------------------
    def compress(self, delta: float = 0.05) -> "ModelGraph":
        """Merge adjacent nodes whose combined size is < delta of total
        parameters. Only chain-internal (single-succ/single-pred) pairs
        merge so the DAG shape is preserved."""
        budget = delta * max(self.total_params, 1.0)
        nodes = [dataclasses.replace(n) for n in self.nodes]
        parent = list(range(len(nodes)))     # union-find into merged groups

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        merged_into: Dict[int, LayerNode] = {i: nodes[i] for i in range(len(nodes))}
        order = self.topological_order()
        for i in order:
            succs = self._succ[i]
            if len(succs) != 1:
                continue
            j = succs[0]
            if len(self._pred[j]) != 1:
                continue
            ri, rj = find(i), find(j)
            if ri == rj:
                continue
            cand = merged_into[ri].merged_with(merged_into[rj])
            if cand.param_bytes < budget:
                parent[rj] = ri
                merged_into[ri] = cand
        # rebuild
        groups: Dict[int, int] = {}
        new_nodes: List[LayerNode] = []
        for i in range(len(nodes)):
            r = find(i)
            if r not in groups:
                groups[r] = len(new_nodes)
                new_nodes.append(merged_into[r])
        new_edges = set()
        for a, b in self.edges:
            ga, gb = groups[find(a)], groups[find(b)]
            if ga != gb:
                new_edges.add((ga, gb))
        return ModelGraph(new_nodes, new_edges)

    # -- serial decomposition (§4.1) ---------------------------------------------
    def serial_decompose(self) -> List[List[int]]:
        """Decompose the DAG into an ordered list of chains.

        A chain is a maximal path of nodes with in/out degree ≤ 1
        internally. Chains are emitted in topological order of their
        heads, giving the serialized sequence the DP walks (§4.1: parallel
        branches become adjacent chains that ``Q2`` may bundle into one
        stage).
        """
        chains: List[List[int]] = []
        assigned = set()
        for i in self.topological_order():
            if i in assigned:
                continue
            chain = [i]
            assigned.add(i)
            cur = i
            while True:
                succs = self._succ[cur]
                if len(succs) != 1:
                    break
                nxt = succs[0]
                if len(self._pred[nxt]) != 1 or nxt in assigned:
                    break
                chain.append(nxt)
                assigned.add(nxt)
                cur = nxt
            chains.append(chain)
        return chains
