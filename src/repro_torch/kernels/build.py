"""Build the CUDA sources of ``repro_torch/csrc/`` into shared libraries
with a plain C interface, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>-<hash>.so``
at the repository root; the hash covers the sources and the ``nvcc``
flags, so an edited kernel is rebuilt and a current one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them; :func:`load_library` builds on first use. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_vops", "kdotp", "kvi_walk", "spm_matmul", "spm_conv2d",
           "spm_fft", "het_mimd", "flash_attention", "ssd_train", "ssd_grad",
           "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> the ptxas resource report (registers, spills) of the last build
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    paths = {name: library_path(name) for name in names}
    procs: Dict[str, Tuple[subprocess.Popen, Path]] = {}
    try:
        for name, out in paths.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                              f"{log}")
            else:
                os.replace(tmp, paths[name])    # atomic: racing builds
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
