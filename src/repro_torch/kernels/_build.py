"""Build the CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface under ``build/repro_torch/`` at the repository root
(a few seconds per source; ``build_all`` runs one ``nvcc`` per source,
all at once).  A library's file name carries a digest of the sources and
flags, so an edited source is rebuilt and a stale library is never
loaded.  Pointers and the stream go in as ``ctypes.c_void_p``; every C
entry point returns ``cudaGetLastError()`` and :func:`check` raises on
anything but 0.  A missing ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Sequence

__all__ = [
    "SOURCES", "build_all", "check", "dtype_code", "instances", "load",
    "ptr", "require_cuda", "stream_of",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("hierarchy_build", "hierarchy_fused", "rmq_fused", "rmq_scan",
           "hierarchy_update", "rmq_short", "rmq_bulk", "flash_attention",
           "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit on PATH or in /usr/local/cuda")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library not built yet, one ``nvcc`` each, in parallel.

    Returns ``{name: compiler output}`` (the ``-Xptxas -v`` report of
    registers, shared memory and spills) for the libraries it built.
    """
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set from ``signatures`` and ``restype`` int."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.rmq_error_string.argtypes = [ctypes.c_int]
        lib.rmq_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.rmq_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer (``None`` for a missing operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def dtype_code(dtype) -> int:
    """The C entry points' value-type code: 0 float32, 1 float64, 2
    bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
    if dtype not in codes:
        raise TypeError(
            f"the CUDA kernels take float32, float64 or bfloat16, got {dtype}")
    return codes[dtype]


def instances(name: str) -> list:
    """The kernel instances that ``csrc/<name>.cu`` launched since the
    last call (the library's ``rmq_instances``, which clears them), by
    name: ``"run"`` / ``"parts"`` for the builds and the update (the run
    layout of ``csrc/build_hopper.cuh`` or the part-by-part reduce),
    ``"V<width>"`` for the query walks, with ``"-fast"`` for the
    one-chunk-a-warp layout.  Empty if the library was never loaded."""
    lib = _libs.get(name)
    if lib is None:
        return []
    fn = lib.rmq_instances
    fn.argtypes, fn.restype = [], ctypes.c_int
    mask = fn()
    walk = name.startswith("rmq_")
    names = []
    for code in range(32):
        if not mask >> code & 1:
            continue
        if walk:
            names.append(f"V{code // 2}" + ("-fast" if code & 1 else ""))
        else:
            names.append("run" if code == 1 else "parts")
    return names


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor on the
    first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
