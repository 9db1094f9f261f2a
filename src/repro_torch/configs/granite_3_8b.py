"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155, GQA. [hf:ibm-granite; shapes as assigned]"""
from ..models.api import ArchSpec
from ..models.transformer import LMConfig
from .base import lm_shapes

CONFIG = LMConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155, head_dim=128, dtype="bfloat16")

SMOKE = LMConfig(
    name="granite-3-8b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=320, vocab_size=512, head_dim=16, dtype="float32",
    remat="none")

SPEC = ArchSpec(arch_id="granite-3-8b", family="lm", model="lm",
                config=CONFIG, smoke_config=SMOKE,
                shapes=lm_shapes(swa=False),
                source="hf:ibm-granite/granite-3.0; hf")
