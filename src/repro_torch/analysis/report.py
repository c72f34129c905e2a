"""Generate the EXPERIMENTS.md §Dry-run/§Roofline tables from artifacts."""

from __future__ import annotations

import glob
import json
import os
from typing import List

from ..obs.render import fmt_seconds as _fmt_t

__all__ = ["roofline_table", "dryrun_summary"]

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str = "reports/dryrun") -> List[dict]:
    cells = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def roofline_table(out_dir: str = "reports/dryrun", mesh: str = "16x16") -> str:
    cells = [c for c in load(out_dir) if c.get("mesh") == mesh]
    cells.sort(key=lambda c: (c["arch"], SHAPE_ORDER.index(c["shape"])
                              if c["shape"] in SHAPE_ORDER else 9))
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "useful-FLOPs | roofline frac | HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("status") == "skipped":
            lines.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                         f"skip (full attn @512k) | — | — | — |")
            continue
        if c.get("status") != "ok":
            lines.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | | | |")
            continue
        r = c.get("roofline", {})
        mem = c.get("full_compile", {}).get("memory", {})
        hbm = mem.get("total_hbm_bytes")
        hbm_s = f"{hbm/1e9:.1f}GB" if hbm else "—"
        lines.append(
            f"| {c['arch']} | {c['shape']} | {_fmt_t(r.get('compute_s'))} | "
            f"{_fmt_t(r.get('memory_s'))} | {_fmt_t(r.get('collective_s'))} | "
            f"{r.get('dominant','—').replace('_s','')} | "
            f"{r.get('useful_flops_ratio',0):.2f} | "
            f"{r.get('roofline_fraction',0):.3f} | {hbm_s} |")
    return "\n".join(lines)


def dryrun_summary(out_dir: str = "reports/dryrun") -> str:
    cells = load(out_dir)
    by_mesh = {}
    for c in cells:
        m = c.get("mesh", "?")
        by_mesh.setdefault(m, {"ok": 0, "skipped": 0, "error": 0})
        by_mesh[m][c.get("status", "error")] = \
            by_mesh[m].get(c.get("status", "error"), 0) + 1
    lines = []
    for m, st in sorted(by_mesh.items()):
        lines.append(f"- mesh {m}: {st.get('ok',0)} compiled ok, "
                     f"{st.get('skipped',0)} documented skips, "
                     f"{st.get('error',0)} errors")
    # collective structure examples
    for c in cells:
        if c.get("status") == "ok" and c["shape"] == "train_4k":
            counts = c.get("full_collective_counts", {})
            lines.append(f"- {c['arch']} train_4k {c['mesh']}: "
                         f"collectives {counts}")
            break
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    print(dryrun_summary())
    print()
    print(roofline_table(mesh=mesh))
