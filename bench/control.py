#!/usr/bin/env python3
"""The readings that a cell's output limits are set from, on the card at
the cell's own size (the benchmark's runs never run this).

  python3 bench/control.py --workload danube-train-4x2048 \
      --seeds 11 12 13 --control-seeds 11 12 13 --out FILE

For each seed, the program's numbers against the plain reference (the
lower reading), and for each control seed the control's: the reference
in the program's place computed in the precision below the configured
bfloat16 (``fp8``: every product's operands rounded to float8 e4m3), and
for a training cell also the fault of half the batch left out (the mean
over the rest). Training needs no window: its numbers come from the
set-up's checked steps. A serving seed serves one cycle of the mix's
batches (its longest prompts among them) and compares a run's sample.
All seeds run in one process. The JSON lines go to ``--out`` and to
standard output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def leaf_detail(run, got: dict, ref: dict) -> dict:
    """Which leaves set the worst-leaf numbers, and the median leaf's gap
    (what a steadier number would read)."""
    import statistics
    from bench import harness, weights
    names = weights.paths(
        harness.reference(run.config["reference"]).layout(run.config))
    out = {}
    for key in ("grad_norms", "change_norms"):
        a, b = got[key], ref[key]
        med = statistics.median(b)
        rel = [abs(x - y) / max(y, med, 1e-30) for x, y in zip(a, b)]
        order = sorted(range(len(rel)), key=lambda i: -rel[i])[:3]
        out[key] = {"median_leaf_gap": statistics.median(rel),
                    "worst": [[names[i], rel[i], b[i] / med] for i in order]}
    return out


def readings(run, control: bool) -> dict:
    """The cell's compared numbers on one seed: the program's, and with
    ``control`` the control's (and a training cell's half-batch fault's)."""
    from bench import harness
    drv = harness.driver(run.mix["kind"])
    out = {"seed": run.seed}
    t0 = time.perf_counter()
    if run.mix["kind"] == "train":
        prog = drv.prepare(run)
        got = prog.checked_steps(run)
        prog.close()
        del prog
        _free()
        ref = drv.reference_readings(run, "fp32")
        out["program"] = drv.compare(got, ref)
        out["losses"] = {"program": got["losses"], "reference": ref["losses"]}
        out["leaves"] = leaf_detail(run, got, ref)
        if control:
            fp8 = drv.reference_readings(run, "fp8")
            out["control_fp8"] = drv.compare(fp8, ref)
            out["control_fp8_leaves"] = leaf_detail(run, fp8, ref)
            out["half_batch"] = drv.compare(drv.reference_readings(
                run, "fp32", rows=run.mix["global_batch"] // 2), ref)
    else:
        prog = drv.prepare(run)
        finished = drv.window(run, prog, batches=run.mix["cycle_batches"])
        del prog
        _free()
        out["program"] = drv.readings(run, finished)
        if control:
            out["control_fp8"] = drv.readings(run, finished, control="fp8")
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    w, config, mix, limits = harness.cell_files(args.workload)
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        run = harness.Run(workload=w, config=config, mix=mix, limits=limits,
                          seed=seed, seconds=0.0, trace=False,
                          device=args.device, t0=time.perf_counter())
        line = json.dumps(readings(run, seed in args.control_seeds))
        print(line, flush=True)
        lines.append(line)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
