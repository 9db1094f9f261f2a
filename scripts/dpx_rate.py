#!/usr/bin/env python3
"""Issue rate of Hopper's 16x2 DPX instructions on the card at hand.

    PYTHONPATH=src python3 scripts/dpx_rate.py

Builds ``scripts/dpx_rate.cu`` with the port's nvcc flags into
``build/repro_torch/``, runs each instruction (VIADDMNMX, VIMNMX3 from
``__viaddmin_s16x2`` / ``__vimin3_s16x2``; VIMNMX from ``__vminu2``;
IADD3 and LOP3 for scale) as 8 independent chains a thread with every
block resident at once, and prints for each: ms (CUDA events), the
instructions a thread issued, lane-instructions per SM per clock
(``clock64()`` in the kernel) and the SASS count of the instruction,
with the card's name and power limit. Then it prints the instructions
``edit_distance``'s half-unit kernel issues for ten interior columns of
one DP row (LMAX 24), by opcode.
"""
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build

SRC = Path(__file__).resolve().with_name("dpx_rate.cu")
OPS = ("VIADDMNMX", "VIMNMX3", "VIMNMX", "IADD3", "LOP3")
SMS, BLOCKS_PER_SM, THREADS, ITERS = 132, 8, 256, 1 << 14


def opcodes(sass: str, kernel: str):
    """The opcodes, in order, of the SASS function whose name holds
    ``kernel``."""
    body = next(b for b in re.split(r"Function : ", sass)[1:]
                if kernel in b.splitlines()[0])
    return [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]


def interior_columns(cuobjdump: str) -> None:
    """Instructions between the 30th and the 40th VIMNMX3 of
    ed_half_kernel<24>: ten interior columns of the first row of its row
    loop (the peeled row 2 holds the first 23)."""
    build.load("edit_distance")
    lib = build.library_path(build.CSRC / "edit_distance.cu")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = opcodes(sass, "ed_half_kernelILi24")
    at = [k for k, op in enumerate(ops) if op == "VIMNMX3"]
    seg = ops[at[29]:at[39]]
    mix = collections.Counter(seg).most_common()
    print(f"ed_half_kernel<24>, 10 interior columns: {len(seg)} "
          f"instructions: {dict(mix)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dpx_rate: no CUDA device", file=sys.stderr)
        return 2
    nvcc = build.find_nvcc()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "dpx_rate.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(lib_path), str(SRC)],
                   check=True, capture_output=True, text=True)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(str(lib_path))
    lib.dpx_rate.restype = ctypes.c_int
    lib.dpx_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    blocks = SMS * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    cyc = torch.empty(blocks, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for op, name in enumerate(OPS):
        n_sass = opcodes(sass, f"rate_kernelILi{op}E").count(name)
        for _ in range(2):   # the first launch warms up
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            code = lib.dpx_rate(op, out.data_ptr(), cyc.data_ptr(), blocks,
                                THREADS, ITERS, stream)
            e.record()
            e.synchronize()
            if code:
                raise RuntimeError(f"dpx_rate: cudaError {code}")
        ms = a.elapsed_time(e)
        per_thread = 8 * ITERS
        cycles = int(cyc.max())
        lanes_per_sm_clk = per_thread * THREADS * BLOCKS_PER_SM / cycles
        print(f"{name}: {ms} ms, {per_thread} a thread, {cycles} cycles, "
              f"{lanes_per_sm_clk:.1f} lane-instructions per SM per clock, "
              f"{n_sass} in the SASS", flush=True)
    interior_columns(cuobjdump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
