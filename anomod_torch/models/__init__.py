"""The port's RCA scorers (counterpart of ``anomod/models``): GCN,
GraphSAGE and GAT so far."""
