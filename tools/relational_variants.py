#!/usr/bin/env python3
"""Time design variants of the relational kernels beside the shipped ones,
on one NVIDIA GPU.

    python3 tools/relational_variants.py [--rounds R]

Builds ``tools/relational_variants.cu`` with ``nvcc`` (the flags of
``repro_torch.kernels.build``) into ``build/tools/``, makes the inputs of
``chip_smoke.py``'s main path from a seed (2,880,404 probe keys over 100,000
slots; 2,880,404 fold values in one segment; 100,000 build keys), holds every
variant and shipped kernel to its plain version (exact; the fp32 sums
within rtol 1e-5), and times each with ``chip_smoke.py``'s timer: ``ms``
(the L2 flushed by a write before each launch, as on the ``kernels``
line), ``clean_ms`` (flushed by a read: no dirty lines to write back) and
``kernel_ms`` (device time per kernel from a ``torch.profiler`` trace of
back-to-back calls, warm L2). Beside them, floors that move the same bytes
with no gathers or folds: a copy of the keys, ``torch.sum`` of the values
(half the fold's bytes), and an empty timed call. Prints one JSON line per
measurement and round, the card's name and power limit, and exits non-zero
if a variant disagrees with its plain version.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBES = {0: "one_key_no_hints", 1: "one_key_largest_l1",
          2: "one_key_l1_hints", 3: "runs_4x4_persistent_prefetch",
          4: "runs_1x4_one_pass", 5: "first_56000_slots_in_smem",
          6: "cluster_of_2_smem"}
SUMS = {0: "runs_4_hint", 1: "runs_4_no_hint", 2: "runs_8_hint",
        3: "runs_8_no_last_fold"}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("relational_variants.py: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 2
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "librelational_variants.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(ROOT / "tools" / "relational_variants.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        print(res.stdout + res.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.variant_probe.argtypes = [I, P, L, P, L, P, P]
    lib.variant_sum.argtypes = [I, P, P, L, P, P, P, P]
    lib.variant_build_two_launches.argtypes = [P, L, P, L, P]
    for fn in (lib.variant_probe, lib.variant_sum, lib.variant_build_two_launches):
        fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    m, n = cs.N_CUSTOMERS, cs.N_ORDERS
    keys = torch.as_tensor(rng.integers(0, m, n).astype(np.int32), device=dev)
    build_keys = torch.as_tensor(rng.permutation(m).astype(np.int32), device=dev)
    slots = ref.build_direct_table_ref(build_keys, m)
    vals = torch.as_tensor(rng.uniform(0, 1, cs.N_TASKS).astype(np.float32),
                           device=dev)
    segs = torch.zeros(cs.N_TASKS, dtype=torch.int32, device=dev)
    found = torch.empty(n, dtype=torch.int32, device=dev)
    table = torch.empty(m, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.float32, device=dev)
    partial = torch.empty(4096, dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    copy = torch.empty_like(keys)
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731
    want_probe = ref.slot_gather_ref(keys, slots)
    want_sum = ref.segment_reduce_ref(vals, segs, 1)

    def probe(v):
        return lambda: lib.variant_probe(v, keys.data_ptr(), n, slots.data_ptr(),
                                         m, found.data_ptr(), stream())

    def fold(v):
        return lambda: lib.variant_sum(v, vals.data_ptr(), segs.data_ptr(),
                                       cs.N_TASKS, partial.data_ptr(),
                                       ticket.data_ptr(), total.data_ptr(),
                                       stream())

    calls = {f"probe/{name}": (probe(v), lambda: found, want_probe, None)
             for v, name in PROBES.items()}
    calls["probe/shipped"] = (lambda: ops.join_probe(keys, slots), None,
                              want_probe, None)
    calls.update({f"sum/{name}": (fold(v), lambda: total, want_sum,
                                  "no_result" if "no_last" in name else 1e-5)
                  for v, name in SUMS.items()})
    calls["sum/shipped"] = (lambda: ops.segment_reduce(vals, segs, 1), None,
                            want_sum, 1e-5)
    calls["build/two_launches"] = (
        lambda: lib.variant_build_two_launches(build_keys.data_ptr(), m,
                                               table.data_ptr(), m, stream()),
        lambda: table, slots, None)
    calls["build/shipped"] = (lambda: ops.build_direct_table(build_keys, m),
                              None, slots, None)
    calls["floor/copy_keys"] = (lambda: copy.copy_(keys), None, None, None)
    calls["floor/torch_sum_values"] = (lambda: torch.sum(vals), None, None, None)
    calls["floor/empty_call"] = (lambda: None, None, None, None)

    timer = cs._Timer()
    for rnd in range(rounds):
        for name, (fn, result, want, tol) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            if isinstance(got, int):
                cs.check(got == 0, f"{name}: launch failed with {got}")
                got = result()
            if want is not None and tol != "no_result":
                if tol is None:
                    cs.check(torch.equal(got, want), f"{name} differs from plain")
                else:
                    torch.testing.assert_close(got, want, rtol=tol, atol=0)
            print(json.dumps({"round": rnd, "name": name, "ms": timer.ms(fn),
                              "clean_ms": timer.ms(fn, clean=True),
                              **cs._kernel_ms(fn)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
