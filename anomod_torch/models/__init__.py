"""The port's RCA scorers (counterpart of ``anomod/models``): the GNNs
(GCN, GraphSAGE, GAT), the temporal models (a GRU and a linear recurrence
over windows), the sequence models (TraceTransformer, the MoE) and the
edge-native line-graph model, each over a whole batch."""

from anomod_torch.models.gnn import GAT, GCN, GraphSAGE
from anomod_torch.models.linegraph import LineGraphRCA
from anomod_torch.models.lru import TemporalLRU
from anomod_torch.models.moe import MoERCA
from anomod_torch.models.temporal import TemporalGCN
from anomod_torch.models.transformer import TraceTransformer

__all__ = ["GCN", "GAT", "GraphSAGE", "TemporalGCN", "TemporalLRU",
           "TraceTransformer", "MoERCA", "LineGraphRCA"]
