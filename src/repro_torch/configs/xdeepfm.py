"""xdeepfm [recsys] — n_sparse=39 embed_dim=10 CIN 200-200-200 MLP 400-400.
[arXiv:1803.05170; paper] — Criteo-style field vocabs (2e5 rows/field)."""
from ..models.api import ArchSpec
from ..models.recsys import XDeepFMConfig
from .base import recsys_shapes

CONFIG = XDeepFMConfig(name="xdeepfm", n_fields=39, field_vocab=200_000,
                       embed_dim=10, cin_layers=(200, 200, 200),
                       dnn_dims=(400, 400))

SMOKE = XDeepFMConfig(name="xdeepfm-smoke", n_fields=8, field_vocab=100,
                      embed_dim=6, cin_layers=(16, 16), dnn_dims=(32, 32))

SPEC = ArchSpec(arch_id="xdeepfm", family="recsys", model="xdeepfm",
                config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
                source="arXiv:1803.05170; paper")
