"""The LM side package: layers, KV caches, the dense transformer and the
architecture API (its serving path; training, MoE, GNN and recsys are not
ported yet)."""
