"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each source is compiled on first use into a plain-C shared library
(``nvcc -shared``, no PyTorch headers, so a build takes seconds) and
loaded with ctypes.  The library lands in ``build/repro_torch/`` at
the root of the checkout, named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# IEEE divides and no contraction anywhere: K3 must agree bit for bit
# with its plain version, and K1/K2's threshold compares must see the
# same quotients as the plain versions.  No --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: pathlib.Path
    seconds: float           # 0.0 when an earlier build was reused
    log: str                 # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def build(source: str) -> BuildInfo:
    """Compile ``csrc/<source>`` unless a build of this exact source
    and flag set exists already."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: concurrent builds never tear
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)
