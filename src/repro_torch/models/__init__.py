"""The LM side package: layers, KV caches, the dense and MoE transformer
and the architecture API (its serving path; training, GNN and recsys are
not ported yet)."""
