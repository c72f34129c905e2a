"""Tiny twins of the cells for the CPU tests: the same files, drivers,
references and readers, at widths a test run holds, on the CPU (the
port's plain kernels)."""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

WIDTHS = {
    "h2o-danube-1.8b": dict(hidden_size=64, intermediate_size=96,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=16, num_hidden_layers=2, vocab_size=256,
                            sliding_window=24),
}
MIXES = {
    "train": dict(global_batch=4, seq_len=32, checked_steps=3,
                  trace_steps=1),
    "serve": dict(callers=4, prompt_min=6, prompt_max=28, new_tokens=12,
                  max_seq=40, cycle_batches=2, sample_requests=8),
}


def tiny_config(name: str) -> dict:
    """The configuration file of ``name`` at tiny widths, its port
    registry entry a tiny twin registered under a name of its own."""
    from repro_torch.models.arch import get_arch, register_arch
    bench = harness.benchmark()
    conf = {c["name"]: c for c in bench["configs"]}[name]
    cfg = copy.deepcopy(harness.load_json(ROOT / conf["file"]))
    cfg.update(WIDTHS[name])
    arch = get_arch(cfg["registry_name"])
    updates = {field: cfg[key] for key, field in cfg["port_fields"].items()
               if hasattr(arch, field) and field != "hd"}
    updates["head_dim"] = cfg["head_dim"]
    cfg["registry_name"] = f"bench-tiny-{name}"
    register_arch(dataclasses.replace(arch, name=cfg["registry_name"],
                                      **updates))
    return cfg


def tiny_run(workload: str, seed: int = 3, seconds: float = 0.5,
             trace: bool = False) -> harness.Run:
    bench = harness.benchmark()
    w, _, mix, limits = harness.cell_files(workload, bench)
    mix = dict(mix, **MIXES[mix["kind"]])
    return harness.Run(workload=w, config=tiny_config(w["config"]), mix=mix,
                       limits=limits, seed=seed, seconds=seconds,
                       trace=trace, device="cpu", t0=time.perf_counter())
