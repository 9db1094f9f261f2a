"""Quickstart: run the real-time search-assistance engine (PyTorch port) on a
synthetic query/tweet stream and print related-query suggestions.

  PYTHONPATH=src python -m repro_torch.quickstart              # on the GPU
  PYTHONPATH=src python -m repro_torch.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.quickstart --layout region

Port of the JAX package's ``examples/quickstart.py``: same stream, same
engine configuration.
"""
import argparse
import sys

from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import StreamConfig, SyntheticStream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--layout", default="hash", choices=("hash", "region"),
                    help="cooccurrence-store layout (default: hash)")
    args = ap.parse_args(argv)
    stream = SyntheticStream(StreamConfig(vocab_size=1024,
                                          queries_per_tick=1024,
                                          tweets_per_tick=64), seed=0)
    cfg = EngineConfig(query_capacity=1 << 14, cooc_capacity=1 << 16,
                       session_capacity=1 << 13, decay_every=4, rank_every=8,
                       cooc_layout=args.layout)
    engine = SearchAssistanceEngine(cfg, device=args.device)

    for t in range(17):
        events, tweets = stream.gen_tick(t)
        result = engine.step(events, tweets)
        if result:
            print(f"tick {t}: rank cycle -> {result['n_suggest']} queries "
                  f"with suggestions")

    # show suggestions for the 5 most frequent queries
    print("\nrelated-query suggestions (top of the vocabulary):")
    for i in range(5):
        q = stream.vocab[i]
        fp = stream.tok.query_fp(q)
        sugg = engine.suggest_fp(fp, k=4)
        pretty = [(stream.tok.text(d), round(s, 3)) for d, s in sugg]
        print(f"  {q!r:28s} -> {pretty}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
