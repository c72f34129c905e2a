"""Cobra as a distributed-execution planner, with the PyTorch port
(``repro_torch``), costed for NVIDIA H100 cards.

    PYTHONPATH=src python examples/plan_distributed_torch.py               # card
    PYTHONPATH=src python examples/plan_distributed_torch.py --device cpu

The twin of ``examples/plan_distributed.py``: the same five (architecture
× workload) cells on a 16×16 mesh, fronted by the same ``CobraSession``
facade, top-3 plans each. The planner costs each plan with the port's
hardware table, ``repro_torch.analysis.roofline.HW``, which by default
describes one H100 SXM (989 TFLOP/s bf16, 3.35 TB/s HBM3, 450 GB/s
NVLink a direction, 80 GB) where the reference's describes a TPU: the
plans and their costs therefore differ from the TPU example's. The first
printed line names the profile used. The session's seed database lives
on ``--device`` (the card by default; without CUDA only ``--device cpu``
runs, and the default raises); the planner itself does arithmetic on the
host. ``main(argv)`` also returns each cell's reports.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.analysis.roofline import HW
from repro_torch.api import CobraSession
from repro_torch.programs import make_orders_customer_db

CELLS = [
    ("stablelm-12b", "train", 4096, 256),
    ("kimi-k2-1t-a32b", "train", 4096, 256),
    ("llama4-scout-17b-a16e", "train", 4096, 256),
    ("qwen2-vl-72b", "decode", 32768, 128),
    ("rwkv6-3b", "decode", 524288, 1),
]


def report_figures(rep) -> dict:
    c, t = rep.choice, rep.artifact
    return {"strategy": c.strategy, "remat": c.remat,
            "microbatch": c.microbatch, "moe_mode": c.moe_mode,
            "est_cost_s": rep.est_cost_s, "compute_s": t["compute_s"],
            "memory_s": t["memory_s"], "collective_s": t["collective_s"],
            "resident_bytes": t["resident_bytes"],
            "feasible": t["feasible"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the seed tables' device: the card by default, "
                         "or cpu")
    args = ap.parse_args(argv)
    # the planner facade needs no relational data; a tiny db seeds the session
    session = CobraSession(make_orders_customer_db(10, 10,
                                                   device=args.device))
    print(f"planner hardware (analysis.roofline.HW; one H100 SXM unless "
          f"overridden): {HW['peak_flops']/1e12:.0f} TFLOP/s, HBM "
          f"{HW['hbm_bw']/1e12:.2f} TB/s, link {HW['ici_bw']/1e9:.0f} GB/s, "
          f"{HW['hbm_bytes']/1e9:.0f} GB a device")
    figures = {}
    for arch, kind, T, B in CELLS:
        reports = session.plan_step(arch, T, B, kind, mesh=(1, 16, 16),
                                    top_k=3)
        print(f"\n=== {arch} / {kind} T={T} B={B} on 16x16 ===")
        for i, rep in enumerate(reports):
            c, t = rep.choice, rep.artifact
            flag = " ← chosen" if i == 0 else ""
            feas = "" if t["feasible"] else "  [infeasible: HBM]"
            print(f"  {c.strategy:8s} remat={c.remat:5s} mb={c.microbatch:<3d} "
                  f"moe={c.moe_mode:13s} step≈{rep.est_cost_s*1e3:8.1f}ms "
                  f"(C {t['compute_s']*1e3:7.1f} | M {t['memory_s']*1e3:7.1f} "
                  f"| X {t['collective_s']*1e3:7.1f}) "
                  f"res={t['resident_bytes']/1e9:5.1f}GB{feas}{flag}")
        figures[f"{arch}/{kind}"] = [report_figures(r) for r in reports]
    return figures


if __name__ == "__main__":
    main()
