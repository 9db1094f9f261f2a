#!/usr/bin/env python3
"""The card's floor for association scoring: ``repro::score_body`` alone.

    PYTHONPATH=src python3 scripts/score_rate.py [--slots N ...]

Builds ``scripts/score_rate.cu`` with the port's nvcc flags into
``build/repro_torch/`` and runs ``repro::score_body`` (the chain that
``score_gate``, ``region_rank`` and ``assoc_score`` run on every slot they
score) with every block resident at once, on inputs each thread makes in
registers: no loads, one checksum store a thread. Prints, with the card's
name, power limit and SM clock: ms per 2^24 scores, cycles (``clock64()``)
and scores per SM per clock; the same for a run that makes the inputs and
skips the body, which is what the input generation costs; and the static
SASS count of each. The score floor is the first less the second: the
time the chain alone takes for 2^24 scores on this card. With
``--slots``, the floor times each slot count. It is measured, not a
bound.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build

SRC = Path(__file__).resolve().with_name("score_rate.cu")
ITERS = 256
# Totals and coefficients of chip_smoke.py's synthetic lanes (C = 2^24) and
# RankConfig's defaults.
TOTALS = (2.0 * 2 ** 24, 4.0 * 2 ** 24)
COEFS = (1.0, 0.15, 0.02, 0.0)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def sass_count(sass: str, kernel: str) -> int:
    body = next(b for b in re.split(r"Function : ", sass)[1:]
                if kernel in b.splitlines()[0])
    return len(re.findall(r"/\*[0-9a-f]{4}\*/\s+\S", body))


def measure() -> dict:
    """{"score": {...}, "inputs": {...}, "floor_ms_per_2_24": x}: ms,
    scores, ms per 2^24 scores, cycles, scores per SM per clock and static
    SASS of each mode, and the score floor, the first's ms per 2^24 less
    the second's."""
    nvcc = build.find_nvcc()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "score_rate.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(lib_path), str(SRC)], check=True, capture_output=True,
                   text=True)
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    lib = ctypes.CDLL(str(lib_path))
    lib.score_rate_blocks_per_sm.restype = ctypes.c_int
    lib.score_rate_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.score_rate.restype = ctypes.c_int
    lib.score_rate.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                               + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
                               + [ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for mode, name in ((1, "score"), (0, "inputs")):
        per_sm = lib.score_rate_blocks_per_sm(mode)
        blocks = sms * per_sm
        out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
        cyc = torch.empty(blocks, dtype=torch.int64, device="cuda")
        times = []
        for _ in range(4):   # the first launch warms up
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            code = lib.score_rate(mode, out.data_ptr(), cyc.data_ptr(),
                                  blocks, ITERS, *TOTALS, *COEFS, stream)
            e.record()
            e.synchronize()
            if code:
                raise RuntimeError(f"score_rate: cudaError {code}")
            times.append(a.elapsed_time(e))
        ms = min(times[1:])
        scores = blocks * 256 * ITERS
        cycles = int(cyc.max())
        res[name] = dict(
            ms=ms, scores=scores, blocks_per_sm=per_sm,
            ms_per_2_24=ms * 2 ** 24 / scores, cycles=cycles,
            per_sm_per_clock=scores / sms / cycles,
            sass_static=sass_count(sass, f"score_rate_kernelILi{mode}E"))
    res["floor_ms_per_2_24"] = (res["score"]["ms_per_2_24"]
                                - res["inputs"]["ms_per_2_24"])
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, nargs="*", default=[],
                    help="scored slot counts to price at the floor")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("score_rate: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    res = measure()
    for name in ("score", "inputs"):
        r = res[name]
        print(f"{name}: {r['ms']!r} ms for {r['scores']} "
              f"({r['blocks_per_sm']} blocks of 256 an SM), "
              f"{r['ms_per_2_24']!r} ms per 2^24, {r['cycles']} cycles, "
              f"{r['per_sm_per_clock']:.4f} per SM per clock, "
              f"{r['sass_static']} static SASS", flush=True)
    floor = res["floor_ms_per_2_24"]
    print(f"score floor: {floor!r} ms per 2^24 scores (measured, not a "
          f"bound)", flush=True)
    for n in args.slots:
        print(f"score floor x {n} slots: {floor * n / 2 ** 24!r} ms "
              f"(measured, not a bound)", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
