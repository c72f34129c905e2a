#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

  python3 bench/run.py --workload danube-train-4x2048 --seed 7 \
      --seconds 30 --trace 0

from the root of a checkout, on a machine with the cells' NVIDIA GPUs.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. Without the
GPUs the cell asks for, or with the JAX package or JAX loaded once the
window has closed, it prints no result and exits with a code other than 0.

The program's kernels build into ``build/repro_torch`` in the checkout on
the first run; the caches a library could keep go under
``build/bench_cache``.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
          ("CUDA_CACHE_PATH", "nv"))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    for var, sub in CACHES:
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench/run.py: src/repro_torch is missing: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    from bench import harness
    bench = harness.benchmark()
    workload, config, mix, limits = harness.cell_files(args.workload, bench)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < workload["chips"]:
        print(f"bench/run.py: {args.workload} needs {workload['chips']} "
              f"CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(workload=workload, config=config, mix=mix,
                      limits=limits, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=_T0)
    result = harness.execute(run, bench)
    if result is None:
        return 3
    print(f"bench: set-up {run.host.get('setup_parts_s')}, reference "
          f"{run.host.get('reference_s')} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
