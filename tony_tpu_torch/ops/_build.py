"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
under the repository root (``.gitignore`` lists ``build/``), keyed by a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags,
then loaded with :mod:`ctypes`. Builds
happen at first use, never at import: this module imports on machines
without ``nvcc`` (the CPU tests import every module). Several sources
build in parallel, one ``nvcc`` each. Any failure raises — there is no
fallback to a plain PyTorch path.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Every kernel source of the port (``csrc/<name>.cu``).
SOURCES = ("flash_decode", "flash_attention", "fused_optim", "int8_matmul",
           "batchnorm")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when the .so was already
# there), "log": nvcc's output (ptxas register/shared-memory report)}.
build_info: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    """The library's path, keyed by its source, every header of ``csrc``
    (a source may include any of them) and the flags."""
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) whatever of ``names`` is not built yet, load
    every library, and return ``{name: CDLL}``."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = []
        for name in todo:
            out = _target(name)
            if out.is_file():
                build_info[name] = {"seconds": 0.0, "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, time.monotonic(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failed = []
        for name, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            build_info[name] = {"seconds": time.monotonic() - t0,
                                "log": log}
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return {n: _libs[n] for n in names}
