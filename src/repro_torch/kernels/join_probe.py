"""Direct-address equi-join probe: the CUDA kernel's wrappers.

The application-side join of Cobra's navigation plans (P0's ``o.customer``)
and prefetch plans: the build side is a direct-address slot table (dense
integer key space, the common case for surrogate keys), slot j holding the
row index of the build row with key j, or -1. The kernels are in
``csrc/join_probe.cu`` (its header says what bounds them and how).

Each wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and bumps the wrapper's ``launches`` count), a CPU tensor takes the
plain version in :mod:`.ref`. There is no fallback from one to the other.
Each CUDA call is one launch: the probe one thread per key, the build one
cooperative launch with a grid barrier between its fill and its scatter.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["join_probe", "build_direct_table"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "cobra_build_direct_table": (_P, _I64, _P, _I64, _P, _P),
    "cobra_join_probe": (_P, _I64, _P, _I64, _P, _P),
}
_MAX_ROWS = (1 << 31) - 1      # row ids are int32


def _lib():
    return build.load("join_probe", _SIGNATURES)


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.ndim != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(t.shape)}")
    return True


def build_direct_table(table_keys: torch.Tensor, key_space: int) -> torch.Tensor:
    """slot[j] = row index of build key j, else -1; (key_space,) int32 on the
    keys' device. Keys outside [0, key_space) are skipped; with duplicate
    keys the smallest row index wins."""
    if not _on_cuda(table_keys, "build_direct_table"):
        return ref.build_direct_table_ref(table_keys, key_space)
    n = table_keys.shape[0]
    if n > _MAX_ROWS or key_space > _MAX_ROWS:
        raise ValueError(f"build_direct_table: {n} keys / {key_space} slots "
                         f"exceed int32 row ids")
    keys = table_keys.to(torch.int32).contiguous()
    slots = torch.empty((key_space,), dtype=torch.int32, device=keys.device)
    if key_space == 0:
        return slots
    with torch.cuda.device(keys.device):
        # the grid barrier counts on the current stream's own counter: two
        # streams may run two builds at once, whose arrivals would mix
        barrier = build.stream_counter(keys.device)[1:]
        err = _lib().cobra_build_direct_table(
            keys.data_ptr(), n, slots.data_ptr(), key_space,
            barrier.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "build_direct_table")
    build_direct_table.launches += 1
    return slots


build_direct_table.launches = 0


def join_probe(probe_keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """probe_keys (N,) integer; table (M,) int32 direct-address slots.
    Returns (N,) int32 row indices into the build side, -1 when no match."""
    if not _on_cuda(probe_keys, "join_probe"):
        return ref.slot_gather_ref(probe_keys, table)
    if table.device != probe_keys.device:
        raise ValueError(f"join_probe: keys on {probe_keys.device}, "
                         f"table on {table.device}")
    n, m = probe_keys.shape[0], table.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        # empty build side: every probe misses
        return torch.full((n,), -1, dtype=torch.int32, device=probe_keys.device)
    if table.dtype != torch.int32 or table.ndim != 1:
        raise ValueError("join_probe: the slot table must be 1-D int32")
    keys = probe_keys.to(torch.int32).contiguous()
    slots = table.contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        err = _lib().cobra_join_probe(
            keys.data_ptr(), n, slots.data_ptr(), m, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "join_probe")
    join_probe.launches += 1
    return out


join_probe.launches = 0
