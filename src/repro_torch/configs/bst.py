"""bst [recsys] — Behavior Sequence Transformer (Alibaba): embed_dim=32,
seq_len=20, 1 block, 8 heads, MLP 1024-512-256. [arXiv:1905.06874; paper]

Item table sized to a production catalog (4M items, Taobao-scale in the
paper's deployment)."""
from ..models.api import ArchSpec
from ..models.recsys import BSTConfig
from .base import recsys_shapes

CONFIG = BSTConfig(name="bst", n_items=4_000_000, n_profile_fields=8,
                   profile_vocab=100_000, embed_dim=32, seq_len=20,
                   n_blocks=1, n_heads=8, d_ff=128,
                   mlp_dims=(1024, 512, 256))

SMOKE = BSTConfig(name="bst-smoke", n_items=1000, n_profile_fields=4,
                  profile_vocab=200, embed_dim=16, seq_len=8, n_blocks=1,
                  n_heads=4, d_ff=32, mlp_dims=(64, 32))

SPEC = ArchSpec(arch_id="bst", family="recsys", model="bst",
                config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
                source="arXiv:1905.06874; paper")
