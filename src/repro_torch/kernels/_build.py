"""Build the CUDA sources under ``csrc/`` with nvcc, load them with ctypes and
launch their entry points on torch's current stream.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>-<hash>.so`` at
the root of the checkout, compiled for ``sm_90a`` with a plain C interface.
The hash covers the source, every shared header (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded.  The build runs at first use, never at import; :func:`build_all`
starts one nvcc per source, all at once.  :func:`library` loads each library
once per process under a lock, so the serve engine's builder thread and the
main thread may be the first callers together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry points of each library: name -> (argtypes, restype)
SIGNATURES = {
    "blest_ss": {
        "blest_pull_ss": ([_P, _P, _P, _I64, _I64, _P], _INT),
        "blest_pull_ss_packed": ([_P, _P, _P, _I64, _I64, _P], _INT),
        "blest_frontier_sweep": (
            [_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _P], _INT),
        "blest_error_string": ([_INT], ctypes.c_char_p),
    },
    "blest_ms": {
        "blest_pull_ms": ([_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_pull_ms_packed": (
            [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_pull_mma_ms_packed": (
            [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_scatter_or": ([_P, _P, _P, _I64, _INT, _P], _INT),
        "blest_error_string": ([_INT], ctypes.c_char_p),
    },
    "blest_serve": {
        "blest_pull_scatter_ms_packed": (
            [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_pull_scatter_mma_ms_packed": (
            [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_pull_ms_packed_queued": (
            [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P], _INT),
        "blest_error_string": ([_INT], ctypes.c_char_p),
    },
}
_LOCK = threading.Lock()  # guards _LIBS and the launch counters
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """nvcc from $CUDA_HOME, $CUDA_PATH, $PATH or the toolkit's default
    install prefix, in that order."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "need the CUDA toolkit (set CUDA_HOME or PATH)")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, pathlib.Path]:
    """Compile every missing library of ``names`` in parallel; return paths."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, todo[name])  # atomic: readers never see a partial .so
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if it is missing; built
    and loaded once per process, whichever thread asks first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err:
        msg = lib.blest_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(name: str, fn: str, device: torch.device, *args,
           counter) -> None:
    """Calls ``fn`` of ``lib<name>`` with ``args`` and torch's current stream
    on ``device``; raises on a refused launch, else adds one to
    ``counter.launches`` (the wrapper's count; under the lock, since the
    serve engine launches from its builder thread too)."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    check(lib, err, fn)
    with _LOCK:
        counter.launches += 1
