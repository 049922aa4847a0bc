"""Graph-native clustering: edge lists as first-class ``solve()`` input
(port of ``repro/graph``).

``repro_torch.graph.edges.EdgeList`` is the COO container the engine
routes — every ported backend can consume one (densify-or-topk routing),
and ``repro_torch.graph.affinity`` is the Borůvka-style ``graph_affinity``
backend that consumes the edge structure directly.
"""
from repro_torch.graph.edges import EdgeList

__all__ = ["EdgeList"]
