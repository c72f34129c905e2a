#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain torch version on the card, drives the Cobra
compile -> batch -> compiled-tier path at TPC-DS SF1 size (2,880,404 orders,
the row count of SF1 ``store_sales``; 100,000 customers, SF1 ``customer``),
checks its outputs, and times every kernel at the shapes that path gives it.

Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``; the two lines before it
are the ``kernels`` JSON line and the card's name and power limit as
``nvidia-smi`` reports them. Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result. Imports nothing of JAX
and nothing of the reference package ``repro``.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_ORDERS = 2_880_404        # TPC-DS SF1 store_sales rows
N_CUSTOMERS = 100_000       # TPC-DS SF1 customer rows
N_TASKS = 2_880_404         # Wilos tasks; roles at the Exp-4 10:1 ratio
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
TIMED_LAUNCHES = 50
DEVICE = "cuda"


def check(ok, what: str) -> None:
    """Fail the run (never stripped, unlike ``assert`` under ``-O``)."""
    if not ok:
        raise AssertionError(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    seconds = build.build_all()
    regs = {}
    for name, log in build.ptxas_report.items():
        regs[name] = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                      if "Used" in ln and "registers" in ln]
    emit({"phase": "build", "seconds": seconds, "sources": list(build.SOURCES),
          "ptxas": regs})


def phase_kernel_parity() -> None:
    """Each kernel against its plain torch version on the same card inputs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    dev = DEVICE
    rng = np.random.default_rng(11)
    cases = []

    def probe_case(name, probe, build_keys, key_space):
        probe = torch.as_tensor(np.asarray(probe, np.int32), device=dev)
        keys = torch.as_tensor(np.asarray(build_keys, np.int32), device=dev)
        slots = ops.build_direct_table(keys, key_space)
        slots_plain = ref.build_direct_table_ref(keys, key_space)
        sync()
        check(torch.equal(slots, slots_plain),
              f"build_direct_table {name}")
        got = ops.join_probe(probe, slots)
        plain = ref.slot_gather_ref(probe, slots_plain)
        sync()
        check(torch.equal(got, plain),
              f"join_probe {name}")
        want = ref.join_probe_np(probe.cpu().numpy(), keys.cpu().numpy())
        check(np.array_equal(got.cpu().numpy(), want),
              f"join_probe {name} vs numpy")
        cases.append({"kernel": "join_probe", "case": name, "n": int(probe.shape[0]),
                      "m": key_space, "max_abs_err": 0})

    # the cases of tests/test_kernel_parity.py::TestJoinProbeParity
    probe_case("empty_probe_side", [], [3, 1, 4], 8)
    probe_case("empty_build_side", [0, 1, 2], [], 0)
    probe_case("all_miss_keys", [100, 200, 300, 7], [1, 2, 3], 512)
    probe_case("duplicate_probe_keys", [2, 2, 5, 2, 5, 9], [9, 5, 2], 16)
    probe_case("random_sweep", rng.integers(0, 4096, size=3000),
               rng.permutation(4096)[:1500], 4096)
    probe_case("duplicate_build_keys", [1, 2, 3, 4], [2, 4, 2, 4, 1], 8)
    probe_case("sf1_orders_customer",
               rng.integers(0, N_CUSTOMERS, size=N_ORDERS),
               rng.permutation(N_CUSTOMERS), N_CUSTOMERS)

    for n, groups in ((0, 4), (1000, 0), (5000, 1), (5000, 7), (100_000, 600),
                      (N_ORDERS, 1), (N_ORDERS, 7), (N_ORDERS, 600),
                      (N_ORDERS, 5000)):
        segs = torch.as_tensor(rng.integers(0, max(groups, 1), size=n)
                               .astype(np.int32), device=dev)
        if groups > 2:
            segs[segs == 1] = 2                    # segment 1 stays empty
        ints = torch.as_tensor(rng.integers(-50, 50, size=n).astype(np.float32),
                               device=dev)
        for op in ref.SEGMENT_OPS:
            got = ops.segment_reduce(ints, segs, groups, op=op)
            plain = ref.segment_reduce_ref(ints, segs, groups, op=op)
            sync()
            check(torch.equal(got, plain),
                  f"segment_reduce {op} n={n} G={groups}")
            cases.append({"kernel": "segment_reduce", "case": f"int_{op}", "n": n,
                          "g": groups, "max_abs_err": 0})
        floats = torch.as_tensor(rng.uniform(0, 1, size=n).astype(np.float32),
                                 device=dev)
        got = ops.segment_reduce(floats, segs, groups, op="sum")
        plain = ref.segment_reduce_ref(floats, segs, groups, op="sum")
        sync()
        # rtol 1e-5: the kernel sums in float32 in a fixed blocked order, the
        # plain version in float64 rounded once
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
        cases.append({"kernel": "segment_reduce", "case": "float_sum", "n": n,
                      "g": groups, "rtol": 1e-5,
                      "max_abs_err": float((got - plain).abs().max())
                      if groups else 0.0})
    emit({"phase": "kernel_parity", "cases": len(cases), "tolerance":
          {"join_probe": "atol=0", "segment_reduce": "exact on integers, "
           "rtol=1e-5 on random fp32 sums"}, "results": cases})


def _outputs_equal(a, b) -> bool:
    return len(a.results) == len(b.results) and all(
        x.outputs == y.outputs for x, y in zip(a.results, b.results))


def phase_main_path(db):
    """P0 compiled with the default rules, a batch of 4 on the compiled tier,
    against the interpreter tier and a numpy reference."""
    import numpy as np
    from repro_torch.api import CobraSession
    from repro_torch.core import CostCatalog
    from repro_torch.programs import make_p0
    from repro_torch.relational import SLOW_REMOTE
    sess = CobraSession(db, CostCatalog(SLOW_REMOTE))
    t0 = time.perf_counter()
    exe = sess.compile(make_p0())
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = exe.run_batch([{}] * 4, tier="compiled")
    sync()
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    interp = exe.run_batch([{}] * 4, tier="interpreter")
    sync()
    interp_s = time.perf_counter() - t0
    check(compiled.tier == "compiled" and interp.tier == "interpreter",
          'compiled.tier == "compiled" and interp.tier == "interpreter"')
    check(_outputs_equal(compiled, interp),
          "compiled != interpreter outputs")
    check(compiled.simulated_s == interp.simulated_s,
          "simulated clocks differ")
    out = compiled.results[0].outputs["result"]
    # independent reference: myFunc(o_id, c_birth_year) = o_id + 2 * year
    orders, customer = db.table("orders"), db.table("customer")
    year = np.empty(customer.nrows, np.int64)
    year[customer.host("c_customer_sk")] = customer.host("c_birth_year")
    want = orders.host("o_id").astype(np.int64) \
        + 2 * year[orders.host("o_customer_sk")]
    check(out == want.tolist(),
          "P0 outputs differ from the numpy reference")
    emit({"phase": "main_path", "program": "P0", "rules": "default",
          "plan": exe.describe(),
          "plan_key_sha256": hashlib.sha256(
              repr(exe.program.body.key()).encode()).hexdigest()[:16],
          "est_cost_s": exe.est_cost_s, "requests": 4,
          "simulated_s": compiled.simulated_s, "compile_s": compile_s,
          "wall_s": wall_s, "interpreter_wall_s": interp_s,
          "outputs_len": len(out), "checksum": int(sum(out))})
    return out


def phase_navigation(db, main_out):
    """P0 as written (empty rule set): its navigation loop probes on the
    card through join_probe."""
    from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
    from repro_torch.core import CostCatalog
    from repro_torch.kernels import ops
    from repro_torch.programs import make_p0
    from repro_torch.relational import SLOW_REMOTE
    sess = CobraSession(db, CostCatalog(SLOW_REMOTE),
                        config=OptimizerConfig(rule_set=RuleSet([])))
    exe = sess.compile(make_p0())
    before = ops.launch_counts()
    t0 = time.perf_counter()
    res = exe.run_batch([{}], tier="compiled")
    sync()
    wall_s = time.perf_counter() - t0
    after = ops.launch_counts()
    probes = sum(cl.kernel_probes for cl in exe.lower()._loops.values())
    check(probes > 0,
          "navigation plan made no kernel probe")
    check(after["join_probe"] > before["join_probe"],
          "join_probe never launched")
    out = res.results[0].outputs["result"]
    check(out == main_out,
          "navigation plan outputs != rewritten plan outputs")
    emit({"phase": "navigation", "program": "P0", "rules": "empty",
          "plan": exe.describe(), "orders": N_ORDERS, "requests": 1,
          "simulated_s": res.simulated_s, "wall_s": wall_s,
          "kernel_probes": probes,
          "launches": {k: after[k] - before[k] for k in after},
          "outputs_len": len(out), "checksum": int(sum(out))})
    return exe


def phase_fold():
    """W_B and W_F on the Wilos tables, with the empty and the default rule
    sets: the empty-rule plans fold their integer accumulators through
    segment_reduce on the card."""
    import numpy as np
    from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
    from repro_torch.core import CostCatalog
    from repro_torch.kernels import ops
    from repro_torch.programs import make_wilos_b, make_wilos_db, make_wilos_f
    from repro_torch.relational import SLOW_REMOTE
    t0 = time.perf_counter()
    db = make_wilos_db(N_TASKS, device=DEVICE)
    build_s = time.perf_counter() - t0
    tasks = db.table("tasks")
    want = {"W_B": {"n": tasks.nrows},
            "W_F": {"states": int(tasks.host("t_state").astype(np.int64).sum())}}
    report, lowered = {}, None
    for name, make in (("W_B", make_wilos_b), ("W_F", make_wilos_f)):
        outs = {}
        for rules in ("empty", "default"):
            cfg = OptimizerConfig(rule_set=RuleSet([])) if rules == "empty" \
                else OptimizerConfig()
            exe = CobraSession(db, CostCatalog(SLOW_REMOTE),
                               config=cfg).compile(make())
            before = ops.launch_counts()
            t0 = time.perf_counter()
            res = exe.run_batch([{}], tier="compiled")
            sync()
            wall_s = time.perf_counter() - t0
            after = ops.launch_counts()
            folds = sum(cl.kernel_folds for cl in exe.lower()._loops.values())
            if rules == "empty":
                check(folds > 0,
                      f"{name}: no kernel fold")
                check(after["segment_reduce"] > before["segment_reduce"],
                      f"{name}: segment_reduce never launched")
                if name == "W_F":
                    lowered = exe.lower()
            outs[rules] = res.results[0].outputs
            report[f"{name}/{rules}"] = {
                "plan": exe.describe(), "simulated_s": res.simulated_s,
                "wall_s": wall_s, "kernel_folds": folds,
                "launches": {k: after[k] - before[k] for k in after},
                "accumulators": {k: outs[rules][k] for k in want[name]}}
        for acc, value in want[name].items():
            check(outs["empty"][acc] == outs["default"][acc] == value,
                  f"{name}.{acc}: {outs['empty'][acc]} / {outs['default'][acc]} / {value}")
    emit({"phase": "fold", "tasks": N_TASKS, "roles": db.table("roles").nrows,
          "db_build_s": build_s, "runs": report})
    return db, lowered


# --------------------------------------------------------------------------
# kernel timing at the main path's shapes
# --------------------------------------------------------------------------

class _Timer:
    """Median time of one call, by CUDA events around each launch, with the
    50 MB L2 flushed before every launch (the hooks find their inputs cold:
    each call uploads fresh keys or deltas).

    ``ms(fn)`` is the device's time: a sleep kernel holds the stream while
    the host queues the whole call, so the events do not wait on the
    wrapper's Python. ``ms(fn, hold=False)`` leaves the stream free, so the
    events also see the host's launch overhead, as a caller does."""

    HOST_LEAD_CYCLES = 1_000_000   # about 0.5 ms of the card's clock

    def __init__(self):
        import torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)

    def ms(self, fn, hold: bool = True, reps: int = TIMED_LAUNCHES) -> float:
        import torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(self.HOST_LEAD_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def _host_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_kernels(order_db, wilos_db, nav_exe, fold_lowered, launches):
    import numpy as np
    import torch
    from repro_torch.compiled import exec as cexec
    from repro_torch.kernels import ops, ref
    timer = _Timer()
    dev = torch.device(DEVICE)
    orders, customer = order_db.table("orders"), order_db.table("customer")
    keys = orders.column("o_customer_sk")
    build_keys = customer.column("c_customer_sk")
    m = N_CUSTOMERS
    slots = ops.build_direct_table(build_keys, m)
    rows = torch.arange(build_keys.shape[0], dtype=torch.int32, device=dev)
    n = keys.shape[0]
    # the W_F fold's deltas: t_state per task, as the loop walk hands them
    fold_cl = next(iter(fold_lowered._loops.values()))
    deltas_np = wilos_db.table("tasks").host("t_state").astype(np.float64)
    deltas = torch.as_tensor(deltas_np.astype(np.float32), device=dev)
    n_fold = deltas.shape[0]
    segs = torch.zeros(n_fold, dtype=torch.int32, device=dev)
    sync()

    def err(a, b):
        sync()
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    def library_probe():
        return torch.where((keys >= 0) & (keys < m), slots[keys.clamp(0, m - 1)
                                                           .long()], -1)

    entries = []
    # join_probe: the navigation probe, N = 2.88M keys over 100,000 slots
    entries.append({
        "name": "join_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_probe.cu",
        "replaces": "src/repro/kernels/join_probe.py:42",
        "launches": launches["join_probe"],
        "max_abs_err": err(ops.join_probe(keys, slots), ref.slot_gather_ref(keys, slots)),
        "ms": timer.ms(lambda: ops.join_probe(keys, slots)),
        "call_ms": timer.ms(lambda: ops.join_probe(keys, slots), hold=False),
        "plain_ms": timer.ms(lambda: ref.slot_gather_ref(keys, slots)),
        "bound_ms": (n * 4 + n * 4 + m * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(library_probe),
        "shape": {"n": n, "m": m}})
    # build_direct_table: the slot table of the navigation probe, once per epoch
    entries.append({
        "name": "build_direct_table", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_probe.cu",
        "replaces": "src/repro/kernels/join_probe.py:26",
        "launches": launches["build_direct_table"],
        "max_abs_err": err(ops.build_direct_table(build_keys, m),
                           ref.build_direct_table_ref(build_keys, m)),
        "ms": timer.ms(lambda: ops.build_direct_table(build_keys, m)),
        "call_ms": timer.ms(lambda: ops.build_direct_table(build_keys, m),
                            hold=False),
        "plain_ms": timer.ms(lambda: ref.build_direct_table_ref(build_keys, m)),
        "bound_ms": (build_keys.shape[0] * 4 + m * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.full((m,), -1, dtype=torch.int32,
                                                  device=dev).index_put_(
            (build_keys.long(),), rows)),
        "shape": {"n": int(build_keys.shape[0]), "m": m}})
    # segment_reduce: the accumulator fold, G = 1 over 2.88M integer deltas
    entries.append({
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:59",
        "launches": launches["segment_reduce"],
        "max_abs_err": err(ops.segment_reduce(deltas, segs, 1),
                           ref.segment_reduce_ref(deltas, segs, 1)),
        "ms": timer.ms(lambda: ops.segment_reduce(deltas, segs, 1)),
        "call_ms": timer.ms(lambda: ops.segment_reduce(deltas, segs, 1),
                            hold=False),
        "plain_ms": timer.ms(lambda: ref.segment_reduce_ref(deltas, segs, 1)),
        "bound_ms": max((n_fold * 4 + n_fold * 4 + 4) / HBM_BYTES_PER_S,
                        n_fold / FP32_OPS_PER_S) * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.zeros(1, dtype=torch.float32,
                                                   device=dev).index_add_(
            0, segs.long(), deltas)),
        "shape": {"n": n_fold, "g": 1}})
    # the whole hook calls, host numpy in and out as the compiled tier runs them
    nav_cl = next(iter(nav_exe.lower()._loops.values()))
    probe_index = cexec._ProbeIndex(("timing",), customer, "c_customer_sk")
    keys_np = orders.host("o_customer_sk")
    hooks = {
        "nav_probe_hook_ms": _host_ms(
            lambda: cexec._probe(nav_cl, probe_index, keys_np)),
        "fold_sum_hook_ms": _host_ms(
            lambda: cexec._fold_sum(fold_cl, deltas_np, dev)),
    }
    return entries, hooks


def main() -> int:
    root = Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()

    smi = phase_device()
    phase_build()
    phase_kernel_parity()

    from repro_torch.kernels import ops
    from repro_torch.programs import make_orders_customer_db
    t0 = time.perf_counter()
    order_db = make_orders_customer_db(N_ORDERS, N_CUSTOMERS, device=DEVICE)
    sync()
    emit({"phase": "database", "orders": N_ORDERS, "customers": N_CUSTOMERS,
          "build_and_analyze_s": time.perf_counter() - t0})

    # the main path: launch counts from 0 just before it, read just after
    ops.reset_launch_counts()
    main_out = phase_main_path(order_db)
    nav_exe = phase_navigation(order_db, main_out)
    wilos_db, fold_lowered = phase_fold()
    launches = ops.launch_counts()
    missing = [k for k, v in launches.items() if v == 0]
    check(not missing,
          f"kernels never launched on the main path: {missing}")

    entries, hooks = phase_kernels(order_db, wilos_db, nav_exe, fold_lowered,
                                   launches)
    emit({"phase": "hooks", **hooks,
          "note": "whole hook call: host keys/deltas to the card, kernel, "
                  "result back to the host"})
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
