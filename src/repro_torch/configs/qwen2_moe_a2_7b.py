"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared (shared ffn 4x1408=5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from ..models.api import ArchSpec
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import lm_shapes

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=0, vocab_size=151936, head_dim=128,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff=1408, n_shared_experts=4,
                  shared_d_ff=1408, capacity_factor=1.25),
    dtype="bfloat16")

SMOKE = LMConfig(
    name="qwen2-moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512, head_dim=32,
    moe=MoEConfig(n_experts=6, top_k=2, d_ff=64, n_shared_experts=1,
                  shared_d_ff=64), dtype="float32", remat="none")

SPEC = ArchSpec(arch_id="qwen2-moe-a2.7b", family="lm", model="lm",
                config=CONFIG, smoke_config=SMOKE, shapes=lm_shapes(swa=False),
                source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf")
