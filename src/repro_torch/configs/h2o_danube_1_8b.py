"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from ..models.api import ArchSpec
from ..models.transformer import LMConfig
from .base import lm_shapes

CONFIG = LMConfig(
    name="h2o-danube-1.8b", n_layers=24, d_model=2560, n_heads=32,
    n_kv_heads=8, d_ff=6912, vocab_size=32000, head_dim=80,
    window=4096, dtype="bfloat16")

SMOKE = LMConfig(
    name="h2o-danube-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, window=16, dtype="float32",
    remat="none")

SPEC = ArchSpec(arch_id="h2o-danube-1.8b", family="lm", model="lm",
                config=CONFIG, smoke_config=SMOKE, shapes=lm_shapes(swa=True),
                source="arXiv:2401.16818; hf")
