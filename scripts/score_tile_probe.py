#!/usr/bin/env python3
"""What the tile design of ``score_gate`` chose, timed beside the kernel.

    PYTHONPATH=src python3 scripts/score_tile_probe.py

Builds ``scripts/score_tile_probe.cu`` (variants of
``src/repro_torch/kernels/csrc/score_gate.cu``, the sweep policy, see that
file) with the port's nvcc flags into ``build/repro_torch/`` and times, by
``chip_smoke.time_ms`` (CUDA events, median of 20 behind a device sleep),
on 2^24 slots of two lane sets: chip_smoke.py's synthetic lanes (80% base
gate, ~71% pass) and the same lanes with a random 1.4% base gate and
``c_ab`` 0 elsewhere (a store at the hash cell's tick 16):

- ``kernel``: ``topk_select.launch_score_gate``, the committed kernel;
- ``tile 1024``, ``tile 2048``, ``tile 4096``: its design at other tiles
  (2048 is the committed one);
- ``staged``: the output tile staged in shared memory and written with
  16-byte stores after a barrier, the list holding c_ab and w_a too;
- ``sum``: the chain swapped for a sum of its inputs (the items' loads
  alone);
- ``no items``: no scoring phase loads (the gate phase, list and stores);
- ``gate bytes``: the gate bytes read and -inf written, nothing else;
- ``fill``: ``torch.Tensor.fill_`` of the 64 MB output.

The kernel, the tiles and ``staged`` must equal the kernel's output bit
for bit, or the script fails. Prints the card's name and power limit, the
``-Xptxas -v`` lines of each variant, one line a lane set and a JSON
record last.
"""
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_name("score_tile_probe.cu")
VARIANTS = {"tile 1024": 0, "tile 2048": 1, "tile 4096": 2, "staged": 3,
            "sum": 4, "no items": 5, "gate bytes": 6}
CHECKED = ("tile 1024", "tile 2048", "tile 4096", "staged")
C = 1 << 24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build():
    nvcc = build.find_nvcc()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "score_tile_probe.so"
    res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC),
                          "-o", str(lib_path), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"score_tile_probe.cu:\n{res.stdout}{res.stderr}")
    ptxas, kernel = [], None
    for ln in (res.stdout + res.stderr).splitlines():
        m = re.search(r"probe_kernelILi(\d)ELi(\d)E", ln)
        if m:
            kernel = f"G={m.group(1)} MODE={m.group(2)}"
        elif kernel and ("registers" in ln or "spill" in ln):
            ptxas.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.score_tile_probe.restype = ctypes.c_int
    lib.score_tile_probe.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                     + [ctypes.c_float] * 7
                                     + [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p])
    return lib, ptxas


def lane_sets(cs, dev):
    """{name: (lanes, ok, scalars)}: the synthetic lanes and a store-like
    1.4% base gate over the same values."""
    import numpy as np
    lanes, ok, _, sc = cs._score_inputs(C, dev)
    rng = np.random.default_rng(cs.SEED + 2)
    live = torch.from_numpy(rng.random(C) < 0.014).to(dev)
    c_ab = torch.where(live, lanes[1], torch.zeros_like(lanes[1]))
    sparse = [lanes[0], c_ab, *lanes[2:]]
    return {"synthetic lanes": (lanes, ok, torch.stack(sc)),
            "1.4% base gate": (sparse, live, torch.stack(sc))}


def main() -> int:
    if not torch.cuda.is_available():
        print("score_tile_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import topk_select as ktk
    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    lib, ptxas = _build()
    for ln in ptxas:
        print(f"  ptxas: {ln}", flush=True)
    dev = torch.device("cuda")
    rc = RankConfig()
    gates = (rc.min_pair_weight, rc.min_src_weight, rc.min_pair_count)
    stream = torch.cuda.current_stream().cuda_stream
    record = {}
    for label, (lanes, ok, scalars) in lane_sets(cs, dev).items():
        ref = torch.empty(C, dtype=torch.float32, device=dev)
        ktk.launch_score_gate(lanes, ok, None, scalars, rc.coefs, gates,
                              None, ref)
        out = torch.empty_like(ref)

        def probe(v):
            code = lib.score_tile_probe(
                v, *(t.data_ptr() for t in lanes), ok.data_ptr(),
                scalars.data_ptr(), *rc.coefs, *gates, out.data_ptr(), C,
                stream)
            if code:
                raise RuntimeError(f"score_tile_probe: cudaError {code}")

        for name in CHECKED:
            out.fill_(7.0)
            probe(VARIANTS[name])
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{name} ({label}) differs from the "
                                     f"kernel")
        ms = {"kernel": cs.time_ms(lambda: ktk.launch_score_gate(
            lanes, ok, None, scalars, rc.coefs, gates, None, ref))}
        for name, v in VARIANTS.items():
            ms[name] = cs.time_ms(lambda v=v: probe(v))
        ms["fill"] = cs.time_ms(lambda: out.fill_(-torch.inf))
        n_ok, n_pass = int(ok.sum()), int((ref > -torch.inf).sum())
        print(f"{label}: {n_ok} base gate, {n_pass} pass; "
              + ", ".join(f"{k} {v!r} ms" for k, v in ms.items()),
              flush=True)
        record[label] = dict(base_gate=n_ok, slots_pass=n_pass, ms=ms)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
