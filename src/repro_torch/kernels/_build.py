"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded
with ctypes.  Builds happen at first use, from the checkout's own sources,
into ``build/repro_torch_kernels/`` at the repository root; a library's
file name carries a hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them.  ``current_stream``
gives every wrapper the stream its launches go to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch_kernels"
SOURCES: Dict[str, str] = {
    "paged_chunk": "paged_chunk.cu",
    "flash_attention": "flash_attention.cu",
    "decode_ring": "decode_ring.cu",
    "moe_ffn": "moe_ffn.cu",
    "ssd": "ssd.cu",
    "rglru_scan": "rglru_scan.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# engines on several threads (one per replica's pump) may ask for the same
# library at once; one builds it, the others wait and load it
_load_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = tuple(SOURCES)
              ) -> Dict[str, Tuple[float, str]]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns ``{name: (seconds,
    compiler output)}`` for what it built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    results: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (secs, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for launches made
    with ``device`` current: ``torch.cuda.current_stream().cuda_stream``
    without the ``torch.cuda.Stream`` object that call builds each time
    (host time every wrapper would pay a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
