"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``build/mipnerf360_torch/``
beside the package (listed in ``.gitignore``). A library's file name carries a
hash of the sources and flags, so an edited source is rebuilt and an unchanged
one is reused. A missing ``nvcc`` or a failed build raises with the compiler's
output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mipnerf360_torch"
# Where the CUDA toolkit lives when neither CUDA_HOME nor PATH names it.
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Compiler output of each build made by this process, by source name.
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then the default toolkit."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of mipnerf360_torch "
        "are built from csrc/ at first use and need the CUDA toolkit")


def source_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name plus a hash of the
    source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name (every source when None),
    one ``nvcc`` process per source, all started together. Sources whose
    library exists already are not rebuilt. Returns {name: library path}."""
    names = list(names) if names is not None else source_names()
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{n}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
