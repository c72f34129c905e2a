"""Render reports/perf/*.json into the EXPERIMENTS.md §Perf log."""

from __future__ import annotations

import glob
import json
import os

from ..obs.render import fmt_seconds as _fmt

__all__ = ["perf_section"]


def perf_section(out_dir: str = "reports/perf") -> str:
    parts = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        its = [i for i in rec["iterations"] if i.get("status") == "ok"]
        if not its:
            continue
        base = its[0]
        best = min(its, key=lambda i: max(i["terms"].values()))
        dom0 = max(base["terms"], key=base["terms"].get)
        gain = base["terms"][dom0] / max(best["terms"][dom0], 1e-12)
        frac_gain = best["roofline_fraction"] / max(
            base["roofline_fraction"], 1e-12)
        parts.append(f"### {rec['pair']} — {rec['arch']} × {rec['shape']}\n")
        parts.append(
            f"Baseline dominant term: **{dom0.replace('_s','')}** "
            f"({_fmt(base['terms'][dom0])}); best variant "
            f"**{best['variant']}** drives it to "
            f"{_fmt(best['terms'][dom0])} (**{gain:.2f}×**), roofline "
            f"fraction {base['roofline_fraction']:.4f} → "
            f"{best['roofline_fraction']:.4f} ({frac_gain:.1f}×).\n")
        parts.append("| iteration | hypothesis (napkin) | compute | memory | "
                     "collective | Δ dominant | verdict |")
        parts.append("|---|---|---|---|---|---|---|")
        for it in its:
            t = it["terms"]
            delta = it.get("delta_on_baseline_dominant")
            d = f"{delta*100:+.0f}%" if delta is not None else "—"
            hyp = it["hypothesis"].replace("|", "/")[:120]
            parts.append(
                f"| {it['variant']} | {hyp} | {_fmt(t['compute_s'])} | "
                f"{_fmt(t['memory_s'])} | {_fmt(t['collective_s'])} | {d} | "
                f"{it['verdict']} |")
        parts.append("")
    return "\n".join(parts)


if __name__ == "__main__":
    print(perf_section())
