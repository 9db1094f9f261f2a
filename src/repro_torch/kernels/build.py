"""Build and load the CUDA kernels from ``csrc/`` at first use.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes``. All missing libraries are
compiled together, one ``nvcc`` process per source. The build directory is
``build/repro_torch/`` at the root of the checkout (git-ignored); each
library's name carries a hash of its source, the shared headers and the
flags, so an edited source rebuilds and an unchanged one loads at once.

A missing ``nvcc`` or a failed build raises: there is no plain fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false: no multiply-add contraction, so the kernels round like their
# plain torch versions (see csrc/assoc_score.cuh). -Xptxas -v: registers,
# shared memory and spills per kernel, kept in each library's .log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(stems=None) -> Dict[str, Path]:
    """Compile every source (or those of ``stems``) whose library is
    missing, in parallel; return ``{stem: library path}``. Raises on any
    failed build."""
    srcs = [src for src in sources() if stems is None or src.stem in stems]
    if stems is not None and len(srcs) != len(set(stems)):
        raise KeyError(f"no kernel source for some of {sorted(stems)}")
    out = {src.stem: library_path(src) for src in srcs}
    todo = [(src, out[src.stem]) for src in srcs
            if not out[src.stem].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``. A library not built
    yet is built on demand, with every other missing one in parallel."""
    if stem not in _LOADED:
        if not (CSRC / f"{stem}.cu").exists():
            raise KeyError(f"no kernel source csrc/{stem}.cu")
        path = library_path(CSRC / f"{stem}.cu")
        if not path.exists():
            build_all()
        _LOADED[stem] = ctypes.CDLL(str(path))
    return _LOADED[stem]


def build_log(stem: str) -> str:
    """The compiler's report (``-Xptxas -v``) for ``csrc/<stem>.cu``."""
    path = library_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return path.read_text() if path.exists() else ""
