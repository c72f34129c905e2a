"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing here includes PyTorch's headers, so a build takes
seconds. Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.

:func:`build_all` starts one ``nvcc`` per source, all at once, and waits for
them; :func:`load` builds (if needed) and loads one library. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load", "check",
           "library_path", "rows16", "aligned16", "stream_counter"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = ("join_probe", "segment_reduce", "flash_attention",
           "flash_attention_bwd", "rwkv6_scan", "rwkv6_scan_bwd", "adamw")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
ptxas_report: Dict[str, str] = {}
# zeroed ticket counters, by (device index, stream)
_counters: Dict[Tuple[int, int], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> None:
    if proc is None:
        return
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        ptxas_report[name] = log.strip()
        os.replace(tmp, out)   # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns the wall seconds the build took."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors = []
        for n, out, tmp, proc in started:
            try:
                _finish(n, out, tmp, proc)
            except RuntimeError as e:   # wait for every nvcc before raising
                errors.append(e)
        if errors:
            raise errors[0]
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` and every ``restype`` an int."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def rows16(t) -> bool:
    """Whether a 4-d tensor's rows (its last dimension) can be read 16 bytes
    at a time: unit stride, the other strides and the width multiples of
    16 bytes' elements, the base 16-byte aligned."""
    per = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and t.shape[3] % per == 0
            and all(st % per == 0 for st in t.stride()[:3]))


def aligned16(*tensors) -> bool:
    """Whether every tensor's base address is 16-byte aligned, so that a
    kernel may read (and write) it 16 bytes at a time. A view into a column
    (``t[1:]``) is not; its kernel then takes four scalar accesses per
    vector over the same elements in the same order."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_counter(device):
    """Two 4-byte words, zeroed once, for the grid-wide tickets and barriers
    of kernels launched on ``device``'s current stream: the first counts
    the last-block tickets of ``segment_reduce`` and of ``adamw``'s norm
    pass, the second
    ``build_direct_table``'s barrier arrivals in its low half and a
    generation in its high half. Every launch leaves the counts at zero,
    so no call clears them. Launches on one stream run one after another
    and share the words; two streams may run launches at once, so each
    stream has its own."""
    import torch
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    counter = _counters.get(key)
    if counter is None:
        with torch.cuda.stream(stream):
            counter = torch.zeros((2,), dtype=torch.int32, device=stream.device)
        _counters[key] = counter
    return counter
