"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is a shared library with a plain C interface:
``nvcc`` compiles it for ``sm_90a`` on first use, from the sources in the
package, into ``build/bee2bee_tpu_torch/`` at the root of the checkout,
and ``ctypes`` loads it. The library's name carries a hash of its source,
the sources it includes (``#include "x.cu"``), the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header never loads
a stale build. The wall time of a build that compiled
something is booked to ``engine.compile_seconds{root="other"}``
(engine/introspect.py). Nothing here
runs at import: the CPU tests import every module, and a machine without
``nvcc`` only fails when a kernel is actually asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bee2bee_tpu_torch"
# every kernel source of the package; build() compiles them all at once
SOURCES = (
    "ragged_attention.cu", "ragged_prefill_attention.cu",
    "ragged_prefill_attention_hd96.cu", "ragged_prefill_attention_hd256.cu",
    "ragged_decode_attention.cu", "ragged_decode_attention_f32.cu", "flash_attention.cu",
    "int8_weight_gemm.cu", "moe_expert_gemm.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# source -> seconds its nvcc took, for the sources this process compiled
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    src = CSRC / source
    text = src.read_bytes()
    h = hashlib.sha256(text)
    for included in re.findall(rb'#include "([^"]+\.cu)"', text):
        h.update((CSRC / included.decode()).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources=SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Writes each compiler log (ptxas's
    register, shared-memory and spill report) beside its library as
    ``.log`` and each compiled source's seconds into ``build_seconds``.
    Raises RuntimeError with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((source, lib, tmp, proc))
    errors = []

    def finish(item):  # each nvcc's output and its seconds since the start
        log, _ = item[3].communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(running))) as pool:
        finished = list(pool.map(finish, running))
    for (source, lib, tmp, proc), (log, seconds) in zip(running, finished):
        build_seconds[source] = seconds
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            errors.append(f"{source} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    if running:
        from ..engine.introspect import book_build_seconds

        book_build_seconds(time.perf_counter() - t0)
    return {source: library_path(source) for source in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build((source,))[source]))
        return lib
