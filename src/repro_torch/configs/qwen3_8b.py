"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from ..models.api import ArchSpec
from ..models.transformer import LMConfig
from .base import lm_shapes

CONFIG = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, dtype="bfloat16")

SMOKE = LMConfig(
    name="qwen3-8b-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, qk_norm=True, dtype="float32",
    remat="none")

SPEC = ArchSpec(arch_id="qwen3-8b", family="lm", model="lm",
                config=CONFIG, smoke_config=SMOKE, shapes=lm_shapes(swa=False),
                source="hf:Qwen/Qwen3-8B; hf")
