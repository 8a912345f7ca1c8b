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

The cold-start plane resolves libraries through an armed
:class:`tony_tpu_torch.ckpt.AOTCache` (:func:`resolve`): one entry holds
the bytes of the libraries a step family launches, each named
``<name>-<hash>.so``, so a later process of the family on the same
toolchain and card writes them into its build directory and loads them
instead of running ``nvcc``. The wrappers launch the library that was
resolved last for their name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Every kernel source of the port (``csrc/<name>.cu``).
SOURCES = ("flash_decode", "flash_attention", "fused_optim", "int8_matmul",
           "batchnorm")

_lock = threading.Lock()
# name -> the library its wrapper launches (the last one resolved).
_libs: Dict[str, ctypes.CDLL] = {}
# path -> every library this process loaded (a path loads once).
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when the .so was already
# there or came from a cache), "log": nvcc's output (ptxas
# register/shared-memory report)}.
build_info: Dict[str, Dict[str, object]] = {}
# nvcc builds this process ran.
builds = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """The release line of ``nvcc --version`` (e.g. ``Cuda compilation
    tools, release 12.9, V12.9.41``), or ``""`` where there is no nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], check=True,
                             capture_output=True, text=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return ""
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[-1] if lines else out.strip()


def library_file(name: str) -> str:
    """The library's file name, keyed by its source, every header of
    ``csrc`` (a source may include any of them) and the flags."""
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"{name}-{digest.hexdigest()[:16]}.so"


def _target(name: str, build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / library_file(name)


def pack_libraries(files: Dict[str, bytes]) -> bytes:
    """A cache payload of library files: a JSON table of names and sizes
    on one line, then the bytes in the table's order."""
    names = sorted(files)
    head = json.dumps([[n, len(files[n])] for n in names]).encode()
    return head + b"\n" + b"".join(files[n] for n in names)


def unpack_libraries(payload: bytes) -> Dict[str, bytes]:
    """The inverse of :func:`pack_libraries`; ``ValueError`` on a
    payload that does not frame."""
    head, sep, body = payload.partition(b"\n")
    if not sep:
        raise ValueError("library payload without a table")
    out: Dict[str, bytes] = {}
    off = 0
    for name, n in json.loads(head):
        if not isinstance(name, str) or "/" in name or off + n > len(body):
            raise ValueError("library payload table does not frame")
        out[name] = body[off:off + n]
        off += n
    if off != len(body):
        raise ValueError("library payload has trailing bytes")
    return out


class Resolution(NamedTuple):
    """What :func:`resolve` did: the loaded libraries by name, whether
    the cache hit (``None`` without a cache) and the nvcc builds run."""
    libs: Dict[str, ctypes.CDLL]
    hit: Optional[bool]
    built: int


def _build_missing(targets: Dict[str, Path]) -> int:
    """Run one nvcc per library whose file is missing, all at once;
    returns the builds run. Raises on any failure."""
    global builds
    procs = []
    for name, out in targets.items():
        if out.is_file():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.monotonic(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    builds += len(procs)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return len(procs)


def _install(path: Path, data: bytes) -> None:
    """Write one cached library into the build directory atomically."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _bind(targets: Dict[str, Path]) -> Dict[str, ctypes.CDLL]:
    """Load every target (once per path) and make it the library its
    name's wrapper launches."""
    for name, path in targets.items():
        key = str(path)
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(key)
        _libs[name] = _loaded[key]
    return {name: _libs[name] for name in targets}


def resolve(names: Sequence[str], *, cache: Optional[Any] = None,
            build_dir: Optional[Union[str, Path]] = None) -> Resolution:
    """Resolve ``names`` into ``build_dir`` (default ``build/kernels``)
    and load them.

    Without a cache, a library missing from the directory is built. With
    an armed :class:`~tony_tpu_torch.ckpt.AOTCache`, the entry of this
    library set (:func:`tony_tpu_torch.ckpt.aot.library_fingerprint`:
    the hashed library names and the toolchain; a library does not
    depend on the shapes it runs at) is consulted first: on a hit the
    cached bytes of every missing library are written into the directory
    and no ``nvcc`` runs; on a miss the missing libraries are built and
    the entry is put with the bytes of all of ``names``. ``names`` may be
    empty (a CPU step family): the entry is then written, hit and missed
    all the same, with no library in it."""
    d = Path(build_dir) if build_dir is not None else BUILD_DIR
    with _lock:
        targets = {n: _target(n, d) for n in dict.fromkeys(names)}
        hit: Optional[bool] = None
        if cache is not None:
            from tony_tpu_torch.ckpt import aot

            fingerprint = aot.library_fingerprint(tuple(targets))
            payload = cache.get(fingerprint)
            hit = payload is not None
            if hit:
                files = unpack_libraries(payload)
                for name, path in targets.items():
                    if path.name not in files:
                        raise RuntimeError(
                            f"AOT entry lacks {path.name}: its fingerprint "
                            f"does not name the libraries it holds")
                    if not path.is_file():
                        _install(path, files[path.name])
                        build_info[name] = {"seconds": 0.0, "log": ""}
        built = _build_missing(targets)
        if cache is not None and not hit:
            cache.put(fingerprint, pack_libraries(
                {p.name: p.read_bytes() for p in targets.values()}))
        return Resolution(_bind(targets), hit, built)


def load(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) whatever of ``names`` is not built yet, load
    every library, and return ``{name: CDLL}``: the libraries the
    wrappers launch. A name already resolved returns its library
    without touching the disk (the wrappers call this every launch)."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            targets = {n: _target(n) for n in todo}
            _build_missing(targets)
            _bind(targets)
        return {n: _libs[n] for n in names}
