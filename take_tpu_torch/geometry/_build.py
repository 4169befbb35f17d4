"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each source compiles at first use, on the machine with the card, into a
shared library with a plain C interface under `build/take_tpu_torch/` at
the root of the checkout. The file name carries a hash of the source, the
shared headers (csrc/*.cuh) and the flags, so an edited source builds anew
and an unchanged one loads the library already built. A failed build raises
with nvcc's output. A source may add flags of its own, declared with it
(geometry/_launch.py).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from take_tpu_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "take_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


@functools.cache
def build(name: str, flags: tuple = ()) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu, with `flags` after NVCC_FLAGS, unless a
    library of the same hash exists.

    Returns (library path, seconds spent compiling, nvcc's output), where
    the output holds ptxas's register and shared-memory report.
    """
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *flags)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    output = proc.stderr + proc.stdout
    log.write_text(output)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, output


def load(name: str, flags: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. Span take.kernels.load."""
    with tracing.span("take.kernels.load"):
        return ctypes.CDLL(str(build(name, flags)[0]))
