"""bert4rec [recsys] — embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional masked-item modeling. [arXiv:1904.06690; paper]

Item vocab sized to 1M (production catalog; the retrieval_cand shape scores
1M candidates). Training uses sampled softmax (8192 shared negatives) —
a full 1M-way softmax over 65k x 200 positions is not a real workload."""
from ..models.api import ArchSpec
from ..models.recsys import Bert4RecConfig
from .base import recsys_shapes

CONFIG = Bert4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                        n_blocks=2, n_heads=2, seq_len=200, d_ff=256)

SMOKE = Bert4RecConfig(name="bert4rec-smoke", n_items=500, embed_dim=32,
                       n_blocks=2, n_heads=2, seq_len=16, d_ff=64)

SPEC = ArchSpec(arch_id="bert4rec", family="recsys", model="bert4rec",
                config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
                source="arXiv:1904.06690; paper")
