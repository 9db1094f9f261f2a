"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from ..models.api import ArchSpec
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import lm_shapes

CONFIG = LMConfig(
    name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=0, vocab_size=32768, head_dim=128, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, capacity_factor=1.25),
    dtype="bfloat16")

SMOKE = LMConfig(
    name="mixtral-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=0, vocab_size=512, head_dim=16, window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=96), dtype="float32",
    remat="none")

SPEC = ArchSpec(arch_id="mixtral-8x22b", family="lm", model="lm",
                config=CONFIG, smoke_config=SMOKE, shapes=lm_shapes(swa=True),
                source="arXiv:2401.04088; hf")
