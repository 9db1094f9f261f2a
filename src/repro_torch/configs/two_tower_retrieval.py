"""two-tower-retrieval [recsys] — embed_dim=256, tower MLP 1024-512-256,
dot interaction, in-batch sampled softmax with logQ correction.
[RecSys'19 (YouTube); unverified] — 10M-item catalog."""
from ..models.api import ArchSpec
from ..models.recsys import TwoTowerConfig
from .base import recsys_shapes

CONFIG = TwoTowerConfig(name="two-tower-retrieval", n_items=10_000_000,
                        n_users=10_000_000, hist_len=50, embed_dim=256,
                        tower_mlp=(1024, 512, 256), logq_correction=True)

SMOKE = TwoTowerConfig(name="two-tower-smoke", n_items=2000, n_users=1000,
                       hist_len=8, embed_dim=32, tower_mlp=(64, 32))

SPEC = ArchSpec(arch_id="two-tower-retrieval", family="recsys",
                model="twotower", config=CONFIG, smoke_config=SMOKE,
                shapes=recsys_shapes(), source="RecSys'19 (YouTube); unverified")
