"""gat-cora [gnn] — 2L d_hidden=8 n_heads=8 attention aggregator.
[arXiv:1710.10903; paper]

The four assigned graph shapes span three regimes: full-batch small (Cora),
fanout-sampled training (Reddit-scale), full-batch large (ogbn-products),
and batched small graphs (molecules). Input feature width / class count
follow each dataset; the GAT body (2L, 8 heads x 8) is fixed per the
assignment. Sampled-subgraph sizes are the static padded bounds produced by
``models.gnn.sample_subgraph`` for batch_nodes=1024, fanout 15-10.
"""
from ..models.api import ArchSpec, ShapeCell
from ..models.gnn import GATConfig

CONFIG = GATConfig(name="gat-cora", d_in=1433, d_hidden=8, n_heads=8,
                   n_layers=2, n_classes=7)

SMOKE = GATConfig(name="gat-smoke", d_in=32, d_hidden=4, n_heads=2,
                  n_layers=2, n_classes=5)

_SEEDS = 1024
_L1 = _SEEDS * 15
_L2 = _L1 * 10

def _pad256(e: int) -> int:
    """Edge arrays pad to a 256 multiple so the edge ('dp') sharding always
    divides — otherwise GSPMD silently replicates the whole edge pipeline
    (observed on ogb_products: 61,859,140 % 16 != 0)."""
    return e + (-e) % 256


SHAPES = (
    ShapeCell("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556,
               "n_edges_padded": _pad256(10556), "d_feat": 1433,
               "n_classes": 7}),
    ShapeCell("minibatch_lg", "train",
              {"n_nodes": _SEEDS + _L1 + _L2, "n_edges": _L1 + _L2,
               "n_edges_padded": _pad256(_L1 + _L2),
               "d_feat": 602, "n_classes": 41, "sampled": 1}),
    ShapeCell("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140,
               "n_edges_padded": _pad256(61859140), "d_feat": 100,
               "n_classes": 47}),
    ShapeCell("molecule", "train",
              {"n_nodes": 30 * 128, "n_edges": 64 * 128,
               "n_edges_padded": 64 * 128, "d_feat": 32,
               "n_classes": 8, "batched": 128}),
)

SPEC = ArchSpec(arch_id="gat-cora", family="gnn", model="gat",
                config=CONFIG, smoke_config=SMOKE, shapes=SHAPES,
                source="arXiv:1710.10903; paper")


def adapt_config(cfg: GATConfig, cell: ShapeCell) -> GATConfig:
    """Feature width / class count follow the shape's dataset."""
    import dataclasses
    return dataclasses.replace(cfg, d_in=cell.dims["d_feat"],
                               n_classes=cell.dims["n_classes"])
