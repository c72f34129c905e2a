"""Roofline analysis from compiled dry-run artifacts.

The port of ``repro.analysis.roofline``. Three terms per (arch × shape ×
mesh), from the ``HW`` table:

    compute    = FLOPs_per_device / peak_flops
    memory     = bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / ici_bw

``HW`` keeps the reference's keys, so one override dict (for instance
through ``ExecutionContext.hw``) works on both packages; its default values
are one NVIDIA H100 SXM's, with NVLink in the interconnect term.

Collective bytes are parsed from compiled HLO text — the sum of
result-shape bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute op (pure-Python regex, copied as it is).

Also reported: MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the
usefulness ratio MODEL_FLOPS / (FLOPs × devices) — catching
remat/redundancy waste.
"""

from __future__ import annotations

import re
from typing import Dict


__all__ = ["HW", "collective_bytes_from_hlo", "roofline_terms"]

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates)
HW = {
    "peak_flops": 989e12,      # bf16 tensor cores, dense
    "hbm_bw": 3.35e12,         # bytes/s, HBM3
    "ici_bw": 450e9,           # bytes/s per direction: NVLink (900 GB/s both ways)
    "hbm_bytes": 80e9,         # device memory
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# match the op only once per collective: plain form or its async -start
# (never -done, whose result repeats the buffer and would double-count)
_COLL_RE = re.compile(
    r"=\s+(?:\(([^)]*)\)|([a-z0-9]+\[[0-9,]*\][^\s]*))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> Dict:
    """Sum result-shape bytes per collective type (per-device program)."""
    by_type: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_str = m.group(1) or m.group(2)
        op = m.group(3)
        b = _shape_bytes(shape_str)
        by_type[op] = by_type.get(op, 0.0) + b
        counts[op] = counts.get(op, 0) + 1
    return {"bytes_per_device": float(sum(by_type.values())),
            "by_type": by_type, "counts": counts}


def model_flops(cfg, spec) -> float:
    """6·N·D with N = active params; decode counts one token per sequence."""
    n_active = cfg.n_active_params()
    if spec["kind"] == "train":
        tokens = spec["seq_len"] * spec["global_batch"]
        return 6.0 * n_active * tokens
    if spec["kind"] == "prefill":
        tokens = spec["seq_len"] * spec["global_batch"]
        return 2.0 * n_active * tokens
    tokens = spec["global_batch"]          # one new token per sequence
    return 2.0 * n_active * tokens


def roofline_terms(cfg, spec, cell: Dict) -> Dict:
    n_dev = cell["n_devices"]
    flops_dev = cell["flops_per_device"]
    bytes_dev = cell["bytes_per_device"]
    coll_dev = cell["collectives"]["bytes_per_device"]

    t_compute = flops_dev / HW["peak_flops"]
    t_memory = bytes_dev / HW["hbm_bw"]
    t_coll = coll_dev / HW["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, spec)
    hlo_total = flops_dev * n_dev
    useful = mf / hlo_total if hlo_total else 0.0
    bound = max(t_compute, t_memory, t_coll)
    # roofline fraction: useful-model-compute time vs. achievable step time
    t_model_ideal = mf / (n_dev * HW["peak_flops"])
    frac = t_model_ideal / bound if bound > 0 else 0.0
    return {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": float(mf),
        "useful_flops_ratio": float(useful),
        "roofline_fraction": float(frac),
        # a dry-run's bytes-accessed count can overstate the device's HBM
        # traffic (fusion differences) — per-term fractions let both views
        # be read
        "fraction_vs_compute": float(t_model_ideal / t_compute)
        if t_compute > 0 else 0.0,
        "fraction_vs_collective": float(
            t_model_ideal / max(t_compute, t_coll))
        if max(t_compute, t_coll) > 0 else 0.0,
    }
