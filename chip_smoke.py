#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (with
``nvcc``'s register and spill report) and drives every path of the port on
the card once, each with the launch counts set to 0 just before it and
read just after, and with the checks of its outputs:

  * the Cobra compile -> batch -> compiled-tier path at TPC-DS SF1 size
    (2,880,404 orders, the row count of SF1 ``store_sales``; 100,000
    customers, SF1 ``customer``): ``join_probe``, ``build_direct_table``,
    ``segment_reduce``; then, after those counts are read, the compiled
    tier's probe and fold hooks alone (host columns to the card, the
    kernel, the result back), each held to the plain version, timed and
    traced;
  * the serving loop (``ServingRuntime.serve``) at SF1: P0 compiled against
    2,000 orders, then fed the SF1 tables without ``analyze()``, so that
    drift re-optimizes it from the join to the prefetch plan; and P0, W_B
    and W_F as written, whose compiled tier launches ``join_probe``,
    ``build_direct_table`` and ``segment_reduce`` inside the loop;
  * the sharded cluster (``ClusterRuntime.serve``, 4 workers) over the
    Wilos tables at SF1 scale, bit-identical to one ``ServingRuntime`` on
    the same stream, ``segment_reduce`` launched inside its workers;
  * LM serving through ``Server.generate`` at the full published widths and
    depths of h2o-danube-1.8b (``flash_attention``) and rwkv6-3b
    (``rwkv6_scan``), seeded random weights: 4 requests of 1,000 / 2,000 /
    3,000 / 4,500 prompt tokens, 32 new tokens each; the prefill's first
    kernel call held to the plain version per request, and the last decode
    call, the decode logits to a full forward, and one prefill and one decode step traced (wall
    and device busy);
  * the same serving traffic through qwen2-vl-72b (M-RoPE, head dim 128)
    at its published width cut to 24 of its 80 layers (145 GB of bf16
    weights at full depth do not fit one card's 80 GB; the cut is listed
    in the phase's line), and minicpm3-4b (MLA: the latent cache, q.k head
    dim 96 and v head dim 64) at full width and depth, both through
    ``flash_attention``;
  * the same traffic through the last four families, all through
    ``flash_attention``: zamba2-1.2b (Mamba2 layers and one shared
    attention block at 6 sites) and seamless-m4t-large-v2 (its encoder,
    without a causal mask, over 4 x 4,608 seeded frame embeddings at the
    prefill, then decoder self and cross attention) at full width and
    depth; llama4-scout-17b-a16e (MoE, 16 experts, top-1) at published
    width cut to 13 of 48 layers, and kimi-k2-1t-a32b (MoE, all 384
    experts, top-8) cut to its first 2 of 61 layers (cuts listed in the
    lines' ``reduced``);
  * training through ``launch.train.train``: h2o-danube-1.8b at its full
    published configuration (24 layers, 1.83B parameters, AdamW, seeded
    weights, the ``SyntheticLM`` stream, 4 x 2,048 tokens a step, 10 steps),
    whose attention's backward is the ``flash_attention_bwd`` kernel (every
    launch on its wgmma body), each step timed with the caching
    allocator's counters and one traced (device split by kind); a first
    step's gradients held to the plain attention's, and one update to
    AdamW's formulas; then the failure drill (a
    crash at step 7 of 12, resumed from the step-5 checkpoint,
    bit-identical to an uninterrupted run) at the published width cut to
    2 layers;
  * training rwkv6-3b through ``launch.train.train`` at its full
    published configuration (32 layers, 3.17B parameters, 4 x 2,048
    tokens a step in four 1-row microbatches, 6 steps), whose scan's
    backward is the ``rwkv6_scan_bwd`` kernel (every launch on its
    tensor-core body), and a first step's gradients held to the plain
    scan's at 2 layers;
  * training under a sharding policy with remat on a 1x1 mesh of the card:
    danube and rwkv6-3b under ``fsdp_tp``, and llama4-scout-17b-a16e at
    its published width cut to 1 of 48 layers under ``fsdp_tp_ep``, the
    MoE layer's sharded path (each rank's own tokens routed), its first
    loss held to an unpolicied ``loss_fn`` on the same parameters and
    batch and its dropped assignments to the same count;
  * one ``CobraSession.plan_step`` report of the step planner under the
    port's default hardware table (one H100 SXM), on the host;
  * the five examples' twins (``examples/*_torch.py``) through their
    ``main()``, each held to what its reference example checks.

Its readings are of the paths no benchmark cell measures; device traces
are read with the harness's own pieces (``bench/tracing.py``). The other
measurements have their own owners: each kernel against its plain
version is ``python3 -m pytest -m cuda tests/test_torch_cuda.py``, a
kernel's time against another checkout's ``chip_kernel_ab.py``, and the
cells ``bench/run.py``.

Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``; the two lines before it
are the ``total`` phase line (the run's wall) and the card's name and
power limit as ``nvidia-smi`` reports them. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX and nothing of the reference package ``repro``.
"""

import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_ORDERS = 2_880_404        # TPC-DS SF1 store_sales rows
N_CUSTOMERS = 100_000       # TPC-DS SF1 customer rows
N_TASKS = 2_880_404         # Wilos tasks; roles at the Exp-4 10:1 ratio
DEVICE = "cuda"

# LM serving traffic: prompt lengths (the last past h2o-danube's 4,096
# window), cache length and new tokens per request
PROMPT_LENS = (1000, 2000, 3000, 4500)
MAX_SEQ = 4608
NEW_TOKENS = 32
SCALE = "full"              # the published configuration, every layer
RELATIONAL = ("join_probe", "build_direct_table", "segment_reduce")
# the serving loop: P0 requests served after the drift (batches of 4)
DRIFT_REQUESTS = 8
DRIFT_ORDERS = 2_000        # the orders P0 is compiled against before the load
# the cluster's mixed stream: W_E requests with distinct worklists of role
# ids, and W_B and W_F among them
CLUSTER_WE_REQUESTS = 32
WORKLIST_LEN = 4
# bf16 weights and activations through every layer: decode logits against
# a full forward of the same tokens (another matmul shape, another bf16
# rounding of each projection) agree to this, on logits of magnitude ~4
# (under 8: about three bf16 spacings there) from models of up to 32
# layers. Two things scale it (logit_atol): the logits are bf16, whose
# spacing doubles with each power of two (qwen2-vl's d_model 8192 gives
# logits near 9), and the difference is a sum of independent roundings,
# one set a layer, which grows as the square root of the depth
# (minicpm3-4b has 62 layers). Measured on an H100: danube 0.082 at 24
# layers, rwkv6 0.053 at 32, qwen2-vl 0.156 at 24 (peak 8.8), minicpm3
# 0.133 at 62; the same serves with the plain attention in place of the
# kernel (the serve phases' witness) read 0.078, 0.164 and 0.127: the
# model's rounding, not the kernel's. minicpm3's figures predate its
# scalings. Logits over a head whose input is divided by s (MiniCPM's
# d_model / dim_model_base = 10) are held at s times their scale
# (logit_atol_of_head), as tightly as without the division; minicpm3's
# decode is held on an fp32 copy of its weights (_decode_checked_in_fp32)
LOGIT_ATOL = 0.1
LOGIT_ATOL_LAYERS = 32
# qwen2-vl-72b's depth on one card: 24 of 80 layers are 47.1 GB of bf16
# weights; with the fp32 cache (3.6 GB) and the prefill's logits and MLP
# activations (~10 GB) they fit in 80 GB, and the published width stays
QWEN2_VL_LAYERS = 24
# llama4-scout-17b-a16e's depth on one card: 48 layers are 215.5 GB of bf16
# weights (ArchConfig.n_params, embeddings included). On an H100 80GB (85.0
# GB of device memory) 12 layers (57.0 GB) peaked at 67.1 GB over the
# phase's serves, 13 (61.4 GB) at 75.8 GB, 9.2 GB free: the prefill's 7.3
# GB of bf16 logits (4 x 4,500 x 202,048), the fp32 cache and the MoE
# buffers on top. 14 (65.8 GB) would leave at most 4.8 GB
LLAMA4_LAYERS = 13
# kimi-k2-1t-a32b's first 2 of 61 layers: the dense one and one MoE layer
# with all 384 experts, top-8 and the shared expert, 39.9 GB (3 layers
# would be 74.1 GB); no expert is cut
KIMI_LAYERS = 2
# the serve phases, in order: (architecture, the kernel its attention or
# scan launches, the ops entry that calls it, the layers it is cut to, or
# None for its published depth)
SERVES = (
    ("h2o-danube-1.8b", "flash_attention", "attention", None),
    ("rwkv6-3b", "rwkv6_scan", "rwkv_scan", None),
    ("qwen2-vl-72b", "flash_attention", "attention", QWEN2_VL_LAYERS),
    ("minicpm3-4b", "flash_attention", "attention", None),
    ("zamba2-1.2b", "flash_attention", "attention", None),
    ("seamless-m4t-large-v2", "flash_attention", "attention", None),
    ("llama4-scout-17b-a16e", "flash_attention", "attention", LLAMA4_LAYERS),
    ("kimi-k2-1t-a32b", "flash_attention", "attention", KIMI_LAYERS))
# training: h2o-danube-1.8b at its full published configuration, 4 x 2,048
# tokens a step (8,192), 10 steps, one of them traced
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_BATCH = 4
TRAIN_T = 2048
TRAIN_STEPS = 10
TRAIN_TRACE_STEP = 5
# training rwkv6-3b at its full published configuration (32 layers, d
# 2,560, 40 heads of 64, d_ff 8,960, vocab 65,536; 3.17 B parameters),
# TRAIN_RWKV_BATCH x 2,048 tokens a step in TRAIN_RWKV_MICROBATCH
# microbatches, the peak under about 75 GB of the card's 85.0 GB.
# Measured on an H100 80GB HBM3 (700 W): at once, 1 row
# peaked at 49.3 GB, 2 at 67.0 GB (0.66-0.79 s a step), 3 ran out of
# memory; 4 rows in two 2-row microbatches ran out too; in 1-row
# microbatches (the fp32 gradient sums add 12.7 GB) 2 and 4 rows peaked at
# 70.8 GB, 4 at 1.13 s a step: more tokens a second than 2 rows at once,
# the optimizer's step shared by more rows. 4 rows: danube's 8,192 tokens
# a step. 6 steps: the traced one and the loss check
TRAIN_RWKV_ARCH = "rwkv6-3b"
TRAIN_RWKV_BATCH = 4
TRAIN_RWKV_MICROBATCH = 4
TRAIN_RWKV_STEPS = 6
# training under make_policy(1x1 mesh, "fsdp_tp", remat="full"): danube at
# TRAIN_BATCH rows, rwkv6-3b at TRAIN_RWKV_BATCH rows at once (3 rows at once
# ran out of memory without remat); the steps of each
TRAIN_REMAT_STEPS = 3
TRAIN_REMAT_RWKV_TOL = 1e-3   # its first loss against the 1-row microbatches'
# MoE under a policy: llama4-scout-17b-a16e at its published width cut to 1
# of 48 layers (4.27 B parameters with the embeddings: bf16 weights and
# gradients 17.1 GB, AdamW's fp32 moments 34.2 GB; 2 layers, 6.47 B, would
# need ~78 GB before activations), 2 x 2,048 tokens a step, make_policy(1x1
# mesh, "fsdp_tp_ep", remat="full"): the MoE layer's sharded path (each
# rank's own tokens routed, the buffer's block summed over the data axis)
# on one rank. Its first loss against an unpolicied loss_fn's on the same
# parameters and batch, relative
TRAIN_MOE_ARCH = "llama4-scout-17b-a16e"
TRAIN_MOE_LAYERS = 1
TRAIN_MOE_BATCH = 2
TRAIN_MOE_TOL = 1e-4
# each trained family's kernels, by ``ArchConfig.family``, one launch a
# layer a step each: (forward, backward, the ops entry the layer calls, its
# plain version in ref, the body every backward launch must run: a key of
# the backward's ``launches_by_body``, and the pieces of kernel names a
# traced training step must show: the forward and the backward's body)
TRAIN_KERNELS = {
    "dense": ("flash_attention", "flash_attention_bwd", "attention",
              "flash_attention_ref", "wgmma", ("flash_fwd", "flash_bwd_wg")),
    "moe": ("flash_attention", "flash_attention_bwd", "attention",
            "flash_attention_ref", "wgmma", ("flash_fwd", "flash_bwd_wg")),
    "ssm": ("rwkv6_scan", "rwkv6_scan_bwd", "rwkv_scan", "rwkv6_scan_ref",
            "mma", ("rwkv6_fwd", "rwkv6_bwd_chunk_mma"))}
# the caching allocator's counters read around each training step: a
# cudaMalloc (num_device_alloc) or a retry after freeing the cache
# (num_alloc_retries) synchronizes, and shows in that step's wall
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_ooms")
# a first step's gradients, kernel against plain attention (both bf16), per
# leaf relative L2: within twice the plain attention's own bf16-vs-fp32
# error, and never held tighter than this
GRAD_REL_L2_FLOOR = 1e-2
# the update check: the reference's schedule (warmup_cosine(3e-4, warmup,
# steps), warmup = max(10, min(200, steps // 10))) is at its peak at step
# 10, the warmup of a TRAIN_STEPS run; AdamW's constants (the reference's)
UPDATE_STEP, UPDATE_LR = 10, 3e-4
ADAMW_B1, ADAMW_B2, ADAMW_EPS, ADAMW_WD = 0.9, 0.95, 1e-8, 0.1
# AdamW's fp32 moments after the step, per leaf relative L2 against the
# fp64 formula (the clipped gradients' bf16 rounding may land one spacing
# apart where the fp32 and fp64 norms differ: about 1e-4 at most)
MOMENT_REL_L2 = 1e-3


def logit_atol(peak: float, layers: int) -> float:
    """LOGIT_ATOL for logits that peak below 8 in magnitude from at most
    LOGIT_ATOL_LAYERS layers; doubled for each further power of two of the
    peak (bf16's spacing there), and scaled by the square root of the depth
    past LOGIT_ATOL_LAYERS."""
    spacing = 2.0 ** math.floor(math.log2(max(peak, 1e-30) / 4))
    return LOGIT_ATOL * max(1.0, spacing) \
        * max(1.0, math.sqrt(layers / LOGIT_ATOL_LAYERS))


def head_scale(arch) -> float:
    """What the head's input is divided by: MiniCPM's d_model /
    dim_model_base, else 1."""
    if arch.dim_model_base is None:
        return 1.0
    return arch.d_model / arch.dim_model_base


def logit_atol_of_head(peak: float, layers: int, arch) -> float:
    """logit_atol for the logits of ``arch``'s head: the head is linear and
    bf16's rounding relative, so logits divided by its ``head_scale`` are
    held to logit_atol of the undivided logits, divided by it in turn."""
    s = head_scale(arch)
    return logit_atol(peak * s, layers) / s


def bf16_spacing(x: float) -> float:
    """The distance between neighbouring bf16 values at magnitude x."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def check(ok, what: str) -> None:
    """Fail the run (never stripped, unlike ``assert`` under ``-O``)."""
    if not ok:
        raise AssertionError(what)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``at_s``, the seconds
    since the script started when it was printed (the phases' walls)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
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


def _ptxas_by_kernel(log: str):
    """nvcc's -Xptxas -v report as {kernel: {"registers", "spill_stores",
    "spill_loads"}}, the names demangled where c++filt is there."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = list(out)
    if len(names) != len(out):
        names = list(out)
    return {re.sub(r"\(anonymous namespace\)::|\(.*$|^void ", "", n): v
            for n, v in zip(names, out.values())}


def phase_build() -> None:
    from repro_torch.kernels import build
    seconds = build.build_all()
    emit({"phase": "build", "seconds": seconds, "sources": list(build.SOURCES),
          "ptxas": {name: _ptxas_by_kernel(log) for name, log
                    in build.ptxas_report.items()}})


def attention_close(got, want, what: str) -> float:
    """Holds a flash_attention output to its plain version's within
    ``ATTN_KERNEL_TOL`` (``tests/_torch_cases.py``, on the path ``main``
    sets); returns the largest absolute difference."""
    import torch
    from _torch_cases import ATTN_KERNEL_TOL
    sync()
    tol = ATTN_KERNEL_TOL[_dt(got)]
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, msg=lambda m: f"{what}: {m}", **tol)
    return float((got - want).abs().max()) if got.numel() else 0.0


def scan_close(got, want, what: str) -> float:
    """Holds rwkv6_scan's (y, state) to the plain version's within
    ``RWKV_TOL`` and ``RWKV_STATE_TOL`` (``tests/_torch_cases.py``);
    returns the largest absolute difference of either."""
    import torch
    from _torch_cases import RWKV_STATE_TOL, RWKV_TOL
    sync()
    (y, s), (y0, s0) = got, want
    tol = RWKV_TOL[_dt(y)]
    check(bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all()),
          f"{what}: non-finite output")
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{what} y: {m}")
    torch.testing.assert_close(s, s0, rtol=RWKV_STATE_TOL,
                               atol=RWKV_STATE_TOL,
                               msg=lambda m: f"{what} state: {m}")
    return max(float((y.float() - y0.float()).abs().max()),
               float((s - s0).abs().max()))


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


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
    card through join_probe. Returns the loop, whose probe hook
    ``phase_hooks`` checks and reads."""
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
    return next(iter(exe.lower()._loops.values()))


def phase_fold():
    """W_B and W_F on the Wilos tables, with the empty and the default rule
    sets: the empty-rule plans fold their integer accumulators through
    segment_reduce on the card. Returns the database, the empty-rule
    plans' outputs and W_F's loop, whose fold hook ``phase_hooks`` checks
    and reads."""
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
    report, loop, fold_outs = {}, None, {}
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
                    loop = next(iter(exe.lower()._loops.values()))
            outs[rules] = res.results[0].outputs
            report[f"{name}/{rules}"] = {
                "plan": exe.describe(), "simulated_s": res.simulated_s,
                "wall_s": wall_s, "kernel_folds": folds,
                "launches": {k: after[k] - before[k] for k in after},
                "accumulators": {k: outs[rules][k] for k in want[name]}}
        for acc, value in want[name].items():
            check(outs["empty"][acc] == outs["default"][acc] == value,
                  f"{name}.{acc}: {outs['empty'][acc]} / {outs['default'][acc]} / {value}")
        fold_outs[name] = outs["empty"]
    emit({"phase": "fold", "tasks": N_TASKS, "roles": db.table("roles").nrows,
          "db_build_s": build_s, "runs": report})
    return db, fold_outs, loop


def phase_hooks(order_db, wilos_db, nav_loop, fold_loop):
    """The compiled tier's probe and fold hooks alone, at SF1, after the
    main path's launch counts are read: each call's output held to the
    plain version (the probe's rows to ``join_probe_np``, its slot table to
    ``build_direct_table_ref``, the fold's sum to ``segment_reduce_ref``),
    then each call timed and traced (``_step_ms``, median of 15): the wall
    a call, the device's busy share and its time by name, the pageable
    copies beside the kernel (ROADMAP A5)."""
    import numpy as np
    import torch
    from repro_torch.compiled import exec as cexec
    from repro_torch.kernels import ref
    customer = order_db.table("customer")
    index = cexec._ProbeIndex(("hook",), customer, "c_customer_sk")
    keys = order_db.table("orders").host("o_customer_sk")
    rows = cexec._probe(nav_loop, index, keys)     # builds the slot table
    check(np.array_equal(rows, ref.join_probe_np(
        keys, customer.host("c_customer_sk"))),
        "probe hook rows != join_probe_np")
    check(torch.equal(index.direct, ref.build_direct_table_ref(
        customer.column("c_customer_sk"), index.key_space())),
        "probe hook slot table != build_direct_table_ref")
    deltas = wilos_db.table("tasks").host("t_state").astype(np.float64)
    total = cexec._fold_sum(fold_loop, deltas, DEVICE)
    # integer states summing below 2**24: every fp32 partial sum is exact
    want = float(ref.segment_reduce_ref(
        torch.as_tensor(deltas, dtype=torch.float32),
        torch.zeros(deltas.shape[0], dtype=torch.int32), 1)[0])
    check(total == want, f"fold hook sum {total} != segment_reduce_ref {want}")
    emit({"phase": "hooks", "orders": N_ORDERS, "customers": N_CUSTOMERS,
          "tasks": N_TASKS,
          "probe_hook": _step_ms(
              lambda: cexec._probe(nav_loop, index, keys), reps=15),
          "fold_sum_hook": _step_ms(
              lambda: cexec._fold_sum(fold_loop, deltas, DEVICE), reps=15)})


def phase_serving(order_db, wilos_db, main_out, fold_outs):
    """``ServingRuntime.serve`` at SF1, in two parts.

    (a) Drift: P0 registered with the paper's Exp 1-3 preset against 2,000
    orders / 100,000 customers (the join plan), the SF1 tables swapped in
    without ``analyze()``, 8 requests served. The first batch's observed
    cardinalities trip the feedback controller: targeted re-analyze,
    recompile to the prefetch plan, swap guard. Responses against the
    numpy-checked main path; ``explain``, ``triage`` and ``scan_plan``.

    (b) The kernels inside the loop: P0, W_B and W_F as written (empty rule
    set), compiled tier from the first batch; ``join_probe``,
    ``build_direct_table`` and ``segment_reduce`` must launch, and the
    outputs equal the ``navigation`` and ``fold`` phases'; each serve's
    wall and device busy time (``_device_busy``). The line's launch counts
    are the whole phase's, from 0 just before it."""
    import dataclasses
    from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
    from repro_torch.core import CostCatalog
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, scan_plan
    from repro_torch.programs import (make_orders_customer_db, make_p0,
                                      make_wilos_b, make_wilos_f)
    from repro_torch.relational import SLOW_REMOTE
    from repro_torch.runtime import ServingRuntime
    ops.reset_launch_counts()

    # (a) drift -> targeted re-analyze -> recompile -> guarded swap
    t0 = time.perf_counter()
    db = make_orders_customer_db(DRIFT_ORDERS, N_CUSTOMERS, device=DEVICE)
    tracer = Tracer()
    session = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig.preset("paper-exp1-3"),
                           tracer=tracer)
    rt = ServingRuntime(session, batch_size=4, drift_threshold=3.0,
                        compile_hot_plans=2)
    rt.register(make_p0())
    sync()
    setup_s = time.perf_counter() - t0
    # where the serve wall goes: the batches and the recompile are traced
    # spans; the feedback's re-analyze and swap-guard replays are timed by
    # wrapping the controller's two methods
    feedback_s = {"refresh": 0.0, "validate_swap": 0.0}
    for name in feedback_s:
        def timed(*args, _name=name, _fn=getattr(rt.feedback, name)):
            t = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                feedback_s[_name] += time.perf_counter() - t
        setattr(rt.feedback, name, timed)
    plan_before = rt.executable("P0").describe()
    check("JOIN" in repr(rt.executable("P0").program.body),
          f"P0 at {DRIFT_ORDERS} orders is not the join plan: {plan_before}")
    db.replace_table(order_db.table("orders"))
    db.replace_table(order_db.table("customer"))
    t0 = time.perf_counter()
    n_compiles = len(tracer.spans("compile"))
    out = rt.serve([("P0", {})] * DRIFT_REQUESTS)
    sync()
    serve_s = time.perf_counter() - t0
    split = {"batches": [sp.wall_s for sp in tracer.spans("batch")],
             "recompile": sum(sp.wall_s for sp in
                              tracer.spans("compile")[n_compiles:]),
             "reanalyze": feedback_s["refresh"],
             "swap_guard_replays": feedback_s["validate_swap"]}
    split["rest"] = serve_s - sum(split["batches"]) - sum(
        v for k, v in split.items() if k != "batches")
    exe = rt.executable("P0")
    check(rt.recompiles >= 1, "no recompile after the drift")
    check("prefetch" in repr(exe.program.body),
          f"P0 did not flip to the prefetch plan: {exe.describe()}")
    check(all(r["result"] == main_out for r in out),
          "served P0 responses differ from the main path's")
    explain = rt.explain("P0")
    check("rules fired" in explain, "explain() shows no rules fired")
    rows = rt.triage()
    check(bool(rows) and rows[0].name == "P0", "triage does not rank P0")
    naive = [s.kind for s in scan_plan(make_p0())]
    check(naive == ["n_plus_one"], f"scan_plan(P0 as written): {naive}")
    after = [s.kind for s in exe.scan()]
    check(after == [], f"the recompiled plan still has signals: {after}")
    drift = {"program": "P0", "orders": N_ORDERS, "customers": N_CUSTOMERS,
          "compiled_against_orders": DRIFT_ORDERS, "requests": len(out),
          "batch_size": 4, "plan_before": plan_before,
          "plan_after": exe.describe(), "recompiles": rt.recompiles,
          "swap_log": rt.feedback.swap_log,
          "drift_events": [{"sql": e.sql, "kind": e.kind, "ratio": e.ratio}
                           for e in rt.feedback.events],
          "simulated_s": rt.simulated_s, "setup_s": setup_s,
          "serve_wall_s": serve_s, "serve_wall_split_s": split,
          "compiled_batches": rt.compiler.compiled_batches,
          "interpreted_batches": rt.compiler.interpreted_batches,
          "explain_rules_fired": next(ln.strip() for ln in explain.splitlines()
                                      if "rules fired" in ln),
          "triage_first_row": dataclasses.asdict(rows[0]),
          "signals_as_written": naive, "signals_after": after,
          "launches": ops.launch_counts()}
    del rt, session, db, out

    # (b) the programs as written: the kernels inside the loop
    cfg = OptimizerConfig(rule_set=RuleSet([]), compile_hot_plans=1)
    before = ops.launch_counts()
    nav = ServingRuntime(CobraSession(order_db, CostCatalog(SLOW_REMOTE),
                                      config=cfg))
    nav.register(make_p0())
    folds = ServingRuntime(CobraSession(wilos_db, CostCatalog(SLOW_REMOTE),
                                        config=cfg))
    folds.register(make_wilos_b())
    folds.register(make_wilos_f())
    (nav_out, nav_s), nav_busy = _device_busy(
        lambda: nav.serve([("P0", {})] * 2))
    (fold_out, fold_s), fold_busy = _device_busy(
        lambda: folds.serve([("W_B", {}), ("W_F", {})] * 2))
    launches = ops.launch_counts()
    inside = {k: launches[k] - before[k] for k in launches}
    missing = [k for k in RELATIONAL if inside[k] == 0]
    check(not missing, f"kernels never launched inside ServingRuntime: {missing}")
    check(all(r["result"] == main_out for r in nav_out),
          "served P0 (as written) differs from the navigation phase")
    for r, name in zip(fold_out, ("W_B", "W_F") * 2):
        check(r.outputs == fold_outs[name],
              f"served {name} (as written) differs from the fold phase")
    emit({"phase": "serving", "drift": drift, "as_written": {
          "programs": {"P0": nav.executable("P0").describe(),
                       "W_B": folds.executable("W_B").describe(),
                       "W_F": folds.executable("W_F").describe()},
          "requests": {"P0": len(nav_out), "W_B": 2, "W_F": 2},
          "serve_wall_s": {"P0": nav_s, "W_B+W_F": fold_s},
          "device_busy_ms": {"P0": nav_busy, "W_B+W_F": fold_busy},
          "simulated_s": {"P0": nav.simulated_s, "W_B+W_F": folds.simulated_s},
          "compiled_batches": nav.compiler.compiled_batches
          + folds.compiler.compiled_batches,
          "recompiles": nav.recompiles + folds.recompiles,
          "launches": inside}, "reduced": []})


def phase_cluster(wilos_db):
    """``ClusterRuntime.serve`` on 4 workers over the Wilos tables at SF1
    (tasks partitioned by ``t_role_id``, roles replicated): W_E requests
    with distinct worklists, W_B and W_F, one ``analyze()`` mid-stream. The
    same stream through one ``ServingRuntime(batch_size=8)`` over an
    unsharded copy must give the same responses, bit for bit, and the same
    tasks afterwards; W_E against numpy. The line's launch counts are the
    cluster's, from 0 just before its serving.

    The single worker serves over ``wilos_db`` itself: the cluster's
    coordinator took its own references to the same (immutable) tables
    when it sharded them, so ``wilos_db`` is the unsharded copy, and a
    second server would only repeat the SF1 ``analyze()``."""
    import numpy as np
    from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.kernels import ops
    from repro_torch.programs import make_wilos_b, make_wilos_e, make_wilos_f
    from repro_torch.runtime import ServingRuntime
    cfg = OptimizerConfig(rule_set=RuleSet([]), compile_hot_plans=1)
    programs = (make_wilos_e, make_wilos_b, make_wilos_f)
    n_roles = wilos_db.table("roles").nrows
    worklists = np.random.default_rng(15).permutation(n_roles)[
        :CLUSTER_WE_REQUESTS * WORKLIST_LEN].reshape(-1, WORKLIST_LEN)
    stream = []
    for i, wl in enumerate(worklists.tolist()):
        stream.append(("W_E", {"worklist": wl}))
        if i % 16 == 7:
            stream.append(("W_B", {}))
        elif i % 16 == 15:
            stream.append(("W_F", {}))
    half = len(stream) // 2

    t0 = time.perf_counter()
    cl = ClusterRuntime(wilos_db, n_workers=4,
                        partition_keys={"tasks": "t_role_id"},
                        affinity={"W_E": "worklist"}, config=cfg)
    for make in programs:
        cl.register(make())
    sync()
    shard_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    (out, first_s), busy = _device_busy(lambda: cl.serve(stream[:half]))
    makespans = [cl.last_makespan_s]
    t1 = time.perf_counter()
    cl.db.analyze()
    sync()
    analyze_s = time.perf_counter() - t1
    (more, second_s), busy2 = _device_busy(lambda: cl.serve(stream[half:]))
    out += more
    makespans.append(cl.last_makespan_s)
    launches = ops.launch_counts()
    check(launches["segment_reduce"] > 0,
          "segment_reduce never launched inside the cluster workers")

    rt = ServingRuntime(CobraSession(wilos_db, config=cfg), batch_size=8)
    for make in programs:
        rt.register(make())
    t1s = time.perf_counter()
    single = rt.serve(stream[:half])
    sync()
    t2s = time.perf_counter()
    wilos_db.analyze()
    sync()
    t3s = time.perf_counter()
    single += rt.serve(stream[half:])
    sync()
    t4s = time.perf_counter()

    diverged = [i for i, (a, b) in enumerate(zip(single, out))
                if a.outputs != b.outputs]
    check(len(out) == len(single) == len(stream) and not diverged,
          f"cluster responses differ from one worker's at {diverged[:5]}")
    tasks, tasks1 = cl.db.table("tasks"), wilos_db.table("tasks")
    check(tasks.schema.names == tasks1.schema.names and all(
        np.array_equal(tasks.host(c), tasks1.host(c))
        for c in tasks.schema.names), "tasks differ after serving")
    role, hours = wilos_db.table("tasks").host("t_role_id"), \
        wilos_db.table("tasks").host("t_hours")
    order = np.argsort(role, kind="stable")
    lo = np.searchsorted(role[order], np.arange(n_roles), side="left")
    hi = np.searchsorted(role[order], np.arange(n_roles), side="right")
    n_we = 0
    for (name, params), res in zip(stream, out):
        if name != "W_E":
            continue
        want = np.concatenate([hours[order[lo[w]:hi[w]]]
                               for w in params["worklist"]]).tolist()
        check(res["result"] == want, f"W_E {params['worklist']} vs numpy")
        n_we += 1
    snap = cl.metrics_snapshot()
    check(snap["workers_serving_requests_served"]
          == sum(w.requests_served for w in cl.workers) == len(stream),
          "the cluster's merged metrics disagree with its workers")
    emit({"phase": "cluster", "tasks": tasks.nrows, "roles": n_roles,
          "workers": cl.n_workers, "partitioned": {"tasks": "t_role_id"},
          "requests": {"W_E": n_we, "W_B": sum(n == "W_B" for n, _ in stream),
                       "W_F": sum(n == "W_F" for n, _ in stream)},
          "worklist_len": WORKLIST_LEN,
          "makespan_s": makespans, "worker_requests":
          [w.requests_served for w in cl.workers],
          "skew": cl.router.skew(), "db": cl.db.stats_dict(),
          "shard_wall_s": shard_s, "serve_wall_s": first_s + second_s,
          "analyze_wall_s": analyze_s,
          "serve_device_busy_ms": busy + busy2 if busy is not None
          and busy2 is not None else None,
          "single_serve_wall_s": (t2s - t1s) + (t4s - t3s),
          "single_analyze_wall_s": t3s - t2s,
          "bit_identical_to_single_worker": True,
          "launches": launches, "reduced": []})


class _Capture:
    """Wraps one ``ops`` entry point for the length of a ``with`` block and
    keeps the first call's inputs and output (the prefill, layer 0) and the
    last call's (the last decode step). It keeps references, not copies:
    the cache slots a call reads are not written again after it. Only the
    keyword arguments named in ``clone`` are copied, before the call: the
    caller overwrites them in place later (the RWKV state)."""

    def __init__(self, ops, name: str, clone=()):
        self.ops, self.name, self.clone = ops, name, clone
        self.first = self.last = None

    def __enter__(self):
        self.orig = getattr(self.ops, self.name)

        def record(*args, **kwargs):
            kept = {k: (v.clone() if k in self.clone and v is not None else v)
                    for k, v in kwargs.items()}
            out = self.orig(*args, **kwargs)
            snap = {"args": list(args), "kwargs": kept, "out": out}
            if self.first is None:
                self.first = snap
            else:
                self.last = snap
            return out

        setattr(self.ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def _n_sites(arch) -> int:
    """Application sites of Zamba2's shared attention block."""
    return max(1, arch.n_layers // max(1, arch.hybrid_every))


def _launches_per_serve(arch) -> int:
    """Kernel launches of one serve (a prefill and NEW_TOKENS - 1 decode
    steps), by family: one a layer and step (the RWKV6 scan, or attention);
    Zamba2's one shared attention block once a site and step; an
    encoder-decoder model's encoder once a layer at the prefill, then
    decoder self and cross attention once a layer and step each."""
    if arch.enc_dec:
        return arch.n_enc_layers + 2 * arch.n_dec_layers * NEW_TOKENS
    if arch.shared_attn:
        return _n_sites(arch) * NEW_TOKENS
    return arch.n_layers * NEW_TOKENS


def _depth(arch) -> int:
    """Blocks a token's logits pass through (``logit_atol``'s layers): the
    encoder's and the decoder's of an encoder-decoder model, Zamba2's Mamba2
    layers and its shared block's sites."""
    if arch.enc_dec:
        return arch.n_enc_layers + arch.n_dec_layers
    if arch.shared_attn:
        return arch.n_layers + _n_sites(arch)
    return arch.n_layers


def _decode_checked_in_fp32(arch) -> bool:
    """Whether the serve phase holds the decode to the full forward on an
    fp32 copy of the weights (attention on the kernel's CUDA-core body), its
    bf16 errors only reported, because the bf16 ones are the model's own
    rounding beyond ``logit_atol``. Random-weight Mamba2 stacks are
    ill-conditioned in depth: a relative perturbation of the input grows
    ~1.3x a layer (8,000x over zamba2's 38), so any two bf16 computations
    of the same logits (the reference's own decode and full forward
    included) differ by O(1). minicpm3-4b with MiniCPM's scalings: its bf16
    decode misses the full forward by more than ``logit_atol_of_head``
    allows its divided logits, and by as much with the plain attention in
    place of the kernel, so the miss is the model's rounding, not the
    kernel's (an H100: 0.0154 and the witness 0.0156 against 0.0139, on
    logits peaking at 0.50; on the fp32 copy 2.3e-6)."""
    return arch.ssm_kind == "mamba2" or arch.dim_model_base is not None


def _speech_server(server, frames):
    """``server`` with the encoder run at its prefill. ``Server.generate``
    passes no encoder inputs, as the reference's does (an encoder-decoder
    model served through it decodes over a zero cross cache), so here each
    step drives ``models.forward`` itself: the stubbed speech frontend's
    frame embeddings as ``enc_inputs`` at the prefill (cache index 0),
    which writes the cross K/V into the cache, and None at each decode
    step, which reads them there."""
    from repro_torch.models import forward

    def step(caches, cache_index, tokens, positions):
        enc = server.frames if cache_index == 0 else None
        logits, caches, _ = forward(server.params, server.arch, tokens,
                                    positions, caches=caches,
                                    cache_index=cache_index, enc_inputs=enc)
        return logits, caches

    server.frames = frames
    server._step = step
    return server


class _Routing:
    """Wraps ``layers.moe_dispatch`` while the ``with`` block runs: keeps
    each call's experts (n, k) and counts its assignments dropped past
    their expert's capacity. With ``replay`` (another run's ``experts``,
    call by call) it routes each call to the recorded experts instead (the
    router's probabilities there still give the gates)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.orig = layers, layers.moe_dispatch
        self.experts, self.dropped = [], []
        pinned = None if self.replay is None else iter(self.replay)

        def dispatch(params, xf, cfg, gate_idx=None):
            if pinned is not None:
                gate_idx = next(pinned).to(xf.device)
            out = self.orig(params, xf, cfg, gate_idx)
            self.experts.append(out[2].view(-1, cfg.top_k))
            self.dropped.append(int((~out[3]).sum()))
            return out

        layers.moe_dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self.layers.moe_dispatch = self.orig


def phase_serve(arch_name: str, kernel: str, entry: str, layers=None):
    """``Server.generate`` at the full published configuration (with
    ``layers``, its published width cut to that many layers: the server
    gets parameters drawn for the cut configuration, the same seed): prefill
    of the 4 right-padded prompts, then batched greedy decode. An
    encoder-decoder model's prefill also runs its encoder over 4 x MAX_SEQ
    seeded frame embeddings (``_speech_server``). A first run captures the
    kernel's inputs; its prefill's first kernel output (layer 0; the
    encoder's) is held to the plain version per request. A second run, with
    nothing wrapped, is the timed main path: its launch count (the family's,
    ``_launches_per_serve``), and its decode logits, are checked. The decode
    logits of the unpadded request are held to a full forward of that
    prompt plus its generated tokens, and, through ``flash_attention``, a
    third run with the plain attention in place of the kernel reads the
    same decode error as a witness (reported). Zamba2's and minicpm3's
    checks run on an fp32 copy of their weights (their bf16 errors are
    reported: ``_decode_checked_in_fp32``).
    MoE models hold the served logits to the plain attention's serve
    instead, fed the served tokens and routed to the served run's experts
    (the same serve with its own routing, and its routing flips, are
    reported beside it): the capacity depends on the tokens a call holds,
    so a full forward of one request drops other assignments than the
    batch; the full forward's error is reported beside the overflow counts
    of both, and held only where both are 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.models import get_arch, init_params, make_caches
    cfg = ServeConfig(arch=arch_name, scale=SCALE, max_batch=len(PROMPT_LENS),
                      max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS, seed=0)
    reduced = []
    t0 = time.perf_counter()
    if layers is None:
        server = Server(cfg, device=DEVICE)
    else:
        full = get_arch(arch_name)
        cut = dataclasses.replace(full, n_layers=layers)
        gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
        server = Server(cfg, params=init_params(gen, cut), device=DEVICE)
        server.arch = cut
        reduced.append(f"n_layers {full.n_layers} -> {layers}")
    arch = server.arch
    if arch.enc_dec:
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        _speech_server(server, torch.randn(
            (len(PROMPT_LENS), MAX_SEQ, arch.d_model), generator=gen,
            device=DEVICE).bfloat16())
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(server.params))
    rng = np.random.default_rng(2024)
    prompts = [rng.integers(0, arch.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]

    want_launches = _launches_per_serve(arch)
    peaks = {}
    # the phase's wall by part (where a smoke run's time goes)
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # a first run through the capture, which keeps the kernel's inputs and
    # output at the prefill's first call and at the last decode call (and,
    # for MoE, each call's experts and dropped assignments)
    torch.cuda.reset_peak_memory_stats()
    with _Capture(ops, entry,
                  clone=("state",) if kernel == "rwkv6_scan" else ()) as cap, \
            _Routing() as served_routing:
        ops.reset_launch_counts()
        capture_outs = server.generate(prompts)
        sync()
        capture_launches = ops.launch_counts()[kernel]
    peaks["capture"] = torch.cuda.max_memory_allocated() / 1e9
    check(capture_launches == want_launches,
          f"{arch_name} (capture run): {kernel} launched {capture_launches} "
          f"times, not {want_launches}")

    # the prefill's first kernel output against the plain version, per
    # request (the plain version's scores of one request fit the card)
    prefill_errs = []
    a = cap.first
    for i in range(len(PROMPT_LENS)):
        args = [x[i:i + 1] if torch.is_tensor(x) and x.ndim == 4 else x
                for x in a["args"]]
        kw = {k: (v[i:i + 1] if torch.is_tensor(v) and v.ndim == 4 else v)
              for k, v in a["kwargs"].items()}
        what = f"{arch_name} prefill layer 0, request {i}"
        if kernel == "flash_attention":
            prefill_errs.append(attention_close(
                a["out"][i:i + 1], ref.flash_attention_ref(*args, **kw), what))
        else:
            prefill_errs.append(scan_close(
                tuple(o[i:i + 1] for o in a["out"]),
                ref.rwkv6_scan_ref(*args, **kw), what))
    # the last decode call against the plain version: the split-key forward
    # and flash_combine over the cache (seamless: its cross attention), or
    # the scan's one token from the carried state
    a = cap.last
    what = f"{arch_name} last decode call"
    if kernel == "flash_attention":
        decode_call_err = attention_close(
            a["out"], ref.flash_attention_ref(*a["args"], **a["kwargs"]), what)
    else:
        decode_call_err = scan_close(
            a["out"], ref.rwkv6_scan_ref(*a["args"], **a["kwargs"]), what)
    del cap, a, args, kw
    part("capture_and_kernel_parity")

    # the main path, uninstrumented: launch counts from 0 just before it,
    # read just after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = server.generate(prompts)
    sync()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    by_body = dict(getattr(ops.KERNELS[kernel], "launches_by_body", {}))
    peaks["main"] = torch.cuda.max_memory_allocated() / 1e9
    t = dict(server.timing)   # the witness's serve below times itself too
    check(launches[kernel] == want_launches,
          f"{arch_name}: {kernel} launched {launches[kernel]} times, "
          f"not {want_launches}")
    check([len(o) for o in outs] == [NEW_TOKENS] * len(PROMPT_LENS),
          f"{arch_name}: wrong number of new tokens")
    served_all = torch.stack(server.step_logits).float()   # (steps, B, V)

    part("main")
    # decode logits of the unpadded (longest) request against a full
    # forward of its prompt and generated tokens
    with _Routing() as full_routing:
        served, full_steps = _decode_and_full_forward(server, prompts, outs)
    decode_err = float((full_steps - served).abs().max())
    peak = float(full_steps.abs().max())
    depth = _depth(arch)
    atol = logit_atol_of_head(peak, depth, arch)
    check(bool(torch.isfinite(served_all).all()),
          f"{arch_name}: non-finite logits")
    j = int(np.argmax(PROMPT_LENS))
    greedy_agree = float((full_steps.argmax(-1).cpu()
                          == torch.as_tensor(outs[j])).float().mean())
    del served, full_steps
    n_moe = arch.n_layers - arch.n_dense_layers if arch.moe else 0
    overflow = None
    if arch.moe:
        overflow = {"served_prefill": sum(served_routing.dropped[:n_moe]),
                    "served_decode": sum(served_routing.dropped[n_moe:]),
                    "full_forward": sum(full_routing.dropped)}
    decode_held_to = "full_forward"
    fp32 = None
    if _decode_checked_in_fp32(arch):
        decode_held_to = "full_forward_fp32"
        server32 = Server(cfg, params=_cast(server.params, torch.float32),
                          device=DEVICE)
        server32.arch = arch
        outs32 = server32.generate(prompts)
        served, full_steps = _decode_and_full_forward(server32, prompts,
                                                      outs32)
        fp32 = {"decode_vs_full_forward_max_abs_err":
                float((full_steps - served).abs().max()),
                "logit_peak": float(full_steps.abs().max())}
        fp32["decode_logit_atol"] = logit_atol_of_head(
            fp32["logit_peak"], depth, arch)
        del server32, outs32, served, full_steps
        check(fp32["decode_vs_full_forward_max_abs_err"]
              <= fp32["decode_logit_atol"],
              f"{arch_name} (fp32 weights): decode logits differ from the "
              f"full forward by {fp32['decode_vs_full_forward_max_abs_err']}"
              f" > {fp32['decode_logit_atol']}")
    elif not arch.moe or sum(overflow.values()) == 0:
        check(decode_err <= atol,
              f"{arch_name}: decode logits differ from the full forward by "
              f"{decode_err} > {atol} (logits peak at {peak})")
    part("full_forward_checks")
    # the witness: the same serve with the plain attention in place of the
    # kernel, so that the model's own bf16 rounding (another matmul shape
    # at decode than in the full forward) is read apart from the kernel's
    plain_err = witness_err = unpinned_err = flips = per_request = None
    rounding_err = witness_atol = None
    if kernel == "flash_attention":
        orig = ops.attention
        ops.attention = _plain_attention
        torch.cuda.reset_peak_memory_stats()
        try:
            if arch.moe:
                # fed the served tokens; once with its own routing, once
                # with the served run's experts: a rounding difference from
                # the kernel flips discrete routing choices, after which the
                # two compute other functions, so only the pinned serve
                # isolates the kernel's part
                with _Routing() as own_routing:
                    unpinned = _teacher_forced(server, prompts, outs)
                flips = sum(int((a != b).any(-1).sum()) for a, b in zip(
                    served_routing.experts, own_routing.experts))
                del own_routing
                with _Routing(replay=served_routing.experts):
                    witness = _teacher_forced(server, prompts, outs)
                # the model's own sensitivity to one bf16 rounding of its
                # attention outputs: the same pinned serve with each output
                # rounded toward zero in place of to nearest
                ops.attention = _plain_attention_rtz
                with _Routing(replay=served_routing.experts):
                    rtz = _teacher_forced(server, prompts, outs)
            else:
                plain_outs = server.generate(prompts)
                served, full_steps = _decode_and_full_forward(
                    server, prompts, plain_outs)
                plain_err = float((full_steps - served).abs().max())
                del served, full_steps, plain_outs
        finally:
            ops.attention = orig
        peaks["witness"] = torch.cuda.max_memory_allocated() / 1e9
        if arch.moe:
            # the served logits, every request and step, against the plain
            # attention's on the same tokens, batches and experts
            decode_held_to = "plain_attention_serve_pinned_routing"
            unpinned_err = float((served_all - unpinned).abs().max())
            witness_err = float((served_all - witness).abs().max())
            per_request = (served_all - witness).abs().amax(dim=(0, 2)).tolist()
            rounding_err = float((witness - rtz).abs().max())
            wpeak = float(witness.abs().max())
            witness_atol = max(logit_atol_of_head(wpeak, depth, arch),
                               rounding_err)
            check(witness_err <= witness_atol,
                  f"{arch_name}: decode logits differ from the plain "
                  f"attention's serve by {witness_err} > {witness_atol} "
                  f"(logits peak at {wpeak}; another rounding of the plain "
                  f"attention moves them by {rounding_err})")
            del witness, unpinned, rtz
    del served_all, served_routing
    part("plain_attention_witness")

    # one prefill and one decode step again, device time against wall time
    caches = make_caches(arch, len(PROMPT_LENS), MAX_SEQ, dtype=torch.float32,
                         device=DEVICE)
    tmax = max(PROMPT_LENS)
    toks = torch.zeros((len(PROMPT_LENS), tmax), dtype=torch.int32,
                       device=DEVICE)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device=DEVICE)
    pos = torch.arange(tmax, dtype=torch.int32,
                       device=DEVICE)[None].expand(len(PROMPT_LENS), tmax)
    last = torch.as_tensor([o[-1] for o in outs], dtype=torch.int32,
                           device=DEVICE)[:, None]
    step_pos = torch.as_tensor([[n + NEW_TOKENS - 2] for n in PROMPT_LENS],
                               dtype=torch.int32, device=DEVICE)
    steps = {
        "prefill": _step_ms(lambda: server._step(caches, 0, toks, pos)),
        "decode": _step_ms(lambda: server._step(
            caches, tmax + NEW_TOKENS - 2, last, step_pos)),
    }
    del caches
    part("step_traces")

    new_tokens = len(PROMPT_LENS) * t["decode_steps"]
    line = {"phase": f"serve_{arch_name}", "arch": arch_name,
            "layers": arch.n_layers, "reduced": reduced,
            "d_model": arch.d_model, "head_dims": _head_dims(arch),
            "params": n_params, "init_s": init_s,
            "prompt_lens": list(PROMPT_LENS), "max_seq": MAX_SEQ,
            "new_tokens_per_request": NEW_TOKENS,
            "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
            "decode_tokens_per_s": new_tokens / t["decode_s"],
            # one batch: every request gets its first token at the prefill's
            # end and its last at the batch's end
            "time_to_first_token_s": t["prefill_s"], "batch_wall_s": wall_s,
            "peak_memory_gb": peaks["main"], "peak_memory_by_run_gb": peaks,
            "card_memory_gb": torch.cuda.get_device_properties(
                DEVICE).total_memory / 1e9,
            "launches": launches, "want_launches": want_launches,
            "launches_by_body": by_body,
            "capture_run_tokens_equal": capture_outs == outs,
            "prefill_layer0_max_abs_err": prefill_errs,
            "last_decode_call_max_abs_err": decode_call_err,
            "decode_held_to": decode_held_to,
            "decode_vs_full_forward_max_abs_err": decode_err,
            "plain_attention_decode_vs_full_forward_max_abs_err": plain_err,
            "decode_logit_atol": atol, "logit_peak": peak,
            "logit_atol_depth": depth, "logit_head_scale": head_scale(arch),
            "decode_err_bf16_spacings": decode_err / bf16_spacing(peak),
            "greedy_tokens_equal_full_forward": greedy_agree,
            "forward_step_ms": steps, "parts_s": parts,
            "sample": outs[j][:8]}
    if fp32 is not None:
        line["fp32_weights"] = fp32
    if arch.moe:
        line.update({
            "decode_vs_plain_attention_serve_max_abs_err": witness_err,
            "decode_vs_plain_attention_serve_per_request": per_request,
            "plain_attention_rounded_toward_zero_max_abs_err": rounding_err,
            "decode_vs_plain_attention_serve_atol": witness_atol,
            "decode_vs_plain_attention_own_routing_max_abs_err":
                unpinned_err,
            "routing_flips_vs_own_routing": flips,
            "moe_overflowing_assignments": overflow,
            "experts": arch.n_experts, "top_k": arch.top_k})
    if arch.enc_dec:
        # T_enc = MAX_SEQ: the prefill writes every cross-cache slot, so a
        # decode step with the cache and a full forward without one attend
        # over the same encoder outputs (with T_enc < MAX_SEQ the cached
        # cross attention would also see the unwritten zero slots)
        line.update({"encoder_frames": MAX_SEQ, "enc_layers": arch.n_enc_layers,
                     "dec_layers": arch.n_dec_layers})
    emit(line)
    del server
    torch.cuda.empty_cache()
    return launches[kernel]


def _decode_and_full_forward(server, prompts, outs):
    """The served decode logits of the unpadded (longest) request, and the
    logits at the same positions of one full forward (no cache) of its
    prompt and generated tokens (with its frames for an encoder-decoder
    model), both fp32 (steps, vocab)."""
    import numpy as np
    import torch
    from repro_torch.models import forward
    j = int(np.argmax(PROMPT_LENS))
    seq = np.concatenate([prompts[j], np.asarray(outs[j][:-1], np.int32)])
    toks = torch.as_tensor(seq[None], device=DEVICE)
    pos = torch.arange(seq.shape[0], dtype=torch.int32, device=DEVICE)[None]
    served = torch.stack([st[j] for st in server.step_logits]).float()
    frames = getattr(server, "frames", None)
    with torch.no_grad():
        full, _, _ = forward(server.params, server.arch, toks, pos,
                             enc_inputs=None if frames is None
                             else frames[j:j + 1])
    return served, full[0, PROMPT_LENS[j] - 1:].float()


def _teacher_forced(server, prompts, outs):
    """The forward calls ``Server.generate`` makes, fed the served tokens
    ``outs`` (not its own argmax): each call holds the same batch as the
    served one. Returns the step logits (steps, B, vocab), fp32."""
    import torch
    from repro_torch.models import make_caches
    B, plens = len(prompts), [len(p) for p in prompts]
    tmax = max(plens)
    caches = make_caches(server.arch, B, MAX_SEQ, dtype=torch.float32,
                         device=DEVICE)
    toks = torch.zeros((B, tmax), dtype=torch.int32, device=DEVICE)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device=DEVICE)
    pos = torch.arange(tmax, dtype=torch.int32, device=DEVICE)[None].expand(
        B, tmax)
    logits, caches = server._step(caches, 0, toks, pos)
    steps = [logits[torch.arange(B, device=DEVICE),
                    torch.as_tensor(plens, device=DEVICE) - 1].float()]
    del logits
    for t in range(NEW_TOKENS - 1):
        cur = torch.as_tensor([[o[t]] for o in outs], dtype=torch.int32,
                              device=DEVICE)
        step_pos = torch.as_tensor([[n + t] for n in plens], dtype=torch.int32,
                                   device=DEVICE)
        logits, caches = server._step(caches, tmax + t, cur, step_pos)
        steps.append(logits[:, -1].float())
    return torch.stack(steps)


def _plain_attention(q, k, v, **kw):
    """The plain attention (``ref.flash_attention_ref``) one request at a
    time: its fp32 scores of a whole prefill batch would not fit beside
    qwen2-vl's weights."""
    import torch
    from repro_torch.kernels import ref
    return torch.cat([ref.flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], **kw)
                      for i in range(q.shape[0])])


def _plain_attention_rtz(q, k, v, **kw):
    """``_plain_attention`` with its fp32 output rounded toward zero to q's
    type (bf16) in place of to nearest: another valid rounding of the same
    values, each element within one bf16 step of the plain version's, as
    the kernel is held to be."""
    import torch
    out = _plain_attention(q.float(), k, v, **kw)
    if q.dtype != torch.bfloat16:
        return out.to(q.dtype)
    return torch.bitwise_and(out.view(torch.int32), -65536).view(
        torch.float32).to(q.dtype)


def _head_dims(arch):
    """(q.k, v) head dims of an architecture's attention."""
    if arch.attn_kind == "mla":
        return [arch.qk_nope_dim + arch.qk_rope_dim, arch.vhd]
    return [arch.hd, arch.hd]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _leaf_rel_l2(a, b) -> dict:
    """Per reference leaf path, ||a - b|| / ||b|| of two gradient trees."""
    from repro_torch.carry import reference_leaves
    la, lb = reference_leaves(a), reference_leaves(b)
    out = {}
    for path, (ts, _) in lb.items():
        num = sum(float(((x.float() - y.float()) ** 2).sum())
                  for x, y in zip(la[path][0], ts))
        den = sum(float((y.float() ** 2).sum()) for y in ts)
        out["/".join(path)] = math.sqrt(num) / max(math.sqrt(den), 1e-30)
    return out


def _first_step_grads(arch, params, batch):
    """The gradient tree of one batch's loss."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.optim import tree_leaves, tree_map
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, arch, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return float(loss.detach()), tree_map(lambda _: next(it), params)


def _update_check(arch, params, batch, grads, loss):
    """The loop's own train step (``make_train_step`` with the optimizer
    ``train`` builds) once, at step UPDATE_STEP (the schedule's peak) from
    fresh AdamW state, on a copy of ``params`` and ``batch``; held leaf by
    leaf against the reference's formulas in fp64 over ``grads``, the
    gradients of the same parameters and batch (the step is deterministic,
    so its own are these): clip to a global norm of 1.0 (the clipped
    gradient rounded to the leaf's type), m = (1-b1) g, v = (1-b2) g^2, and
    p + u with u = -lr (m^ / (sqrt(v^) + eps) + wd p). AdamW's moments must
    agree within MOMENT_REL_L2 (relative L2); each bf16 parameter within
    one bf16 spacing of the exact sum plus 2**-7 of its update (the
    update's own rounding to bf16 and the gradient's). An update that
    leaves a parameter alone fails wherever the exact update is larger
    than that limit: their count is printed and must not be 0. On the card
    the step takes the fused AdamW pass (``kernels.adamw``), two launches:
    ``adamw_launches``."""
    import torch
    from repro_torch.kernels import adamw as fused_adamw
    from repro_torch.launch.specs import make_optimizer, make_train_step
    from repro_torch.optim import tree_leaves, tree_map
    start = tree_map(lambda t: t.clone(), params)
    opt = make_optimizer(arch, total_steps=TRAIN_STEPS)
    state = opt.init(start)
    before = fused_adamw.launches
    new, state, _, metrics = make_train_step(arch, optimizer=opt)(
        start, state, UPDATE_STEP, {k: v.clone() for k, v in batch.items()})
    launches = fused_adamw.launches - before
    p0, p1 = tree_leaves(params), tree_leaves(new)
    m1, v1, g = tree_leaves(state["m"]), tree_leaves(state["v"]), \
        tree_leaves(grads)
    norm = math.sqrt(sum(float((x.double() ** 2).sum()) for x in g))
    scale = min(1.0, 1.0 / max(norm, 1e-9))
    t = UPDATE_STEP + 1.0
    bc1, bc2 = 1 - ADAMW_B1 ** t, 1 - ADAMW_B2 ** t
    worst_m = worst_v = worst_p = 0.0
    teeth = n = 0
    for gi, a, b, m, v in zip(g, p0, p1, m1, v1):
        gc = (gi.double() * scale).to(gi.dtype).double()
        m_want, v_want = (1 - ADAMW_B1) * gc, (1 - ADAMW_B2) * gc * gc
        worst_m = max(worst_m, float((m.double() - m_want).norm()
                                     / m_want.norm().clamp(min=1e-300)))
        worst_v = max(worst_v, float((v.double() - v_want).norm()
                                     / v_want.norm().clamp(min=1e-300)))
        u = -UPDATE_LR * ((m_want / bc1) / (torch.sqrt(v_want / bc2)
                                            + ADAMW_EPS)
                          + ADAMW_WD * a.double())
        want = a.double() + u
        big = torch.maximum(want.abs(), b.double().abs()).clamp(min=1e-30)
        tol = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8) \
            + 2.0 ** -7 * u.abs()
        worst_p = max(worst_p, float(((b.double() - want).abs() / tol).max()))
        teeth += int((u.abs() > tol).sum())
        n += u.numel()
        del gc, m_want, v_want, u, want, big, tol
    out = {"step": UPDATE_STEP, "lr": UPDATE_LR, "grad_norm": norm,
           "grad_norm_step": float(metrics["grad_norm"]),
           "clip_scale": scale, "loss_step": float(metrics["loss"]),
           "loss_grads": loss,
           "moments_rel_l2_max": {"m": worst_m, "v": worst_v},
           "param_err_over_limit_max": worst_p,
           "elements": n, "elements_a_no_op_would_fail": teeth,
           "adamw_launches": launches,
           "limit": f"m, v: relative L2 <= {MOMENT_REL_L2}; each parameter "
                    f"within one bf16 spacing + 2**-7 x |update| of the "
                    f"fp64 formula"}
    check(out["loss_step"] == loss,
          f"update check: the step's loss {out['loss_step']} is not the "
          f"gradients' {loss} (the step is not deterministic?)")
    check(abs(out["grad_norm_step"] - norm) <= 1e-4 * norm,
          f"update check: grad norm {out['grad_norm_step']} vs {norm}")
    check(worst_m <= MOMENT_REL_L2 and worst_v <= MOMENT_REL_L2,
          f"update check: AdamW moments off the formula: {out}")
    check(worst_p <= 1.0, f"update check: parameters off the formula: {out}")
    check(teeth > 0, f"update check: no update exceeds its limit: {out}")
    check(launches == 2, f"update check: the step took {launches} launches "
                         f"of the fused AdamW pass, not 2: {out}")
    return out


def phase_train(arch_name: str, batch: int = TRAIN_BATCH,
                steps: int = TRAIN_STEPS, microbatch: int = 1):
    """``launch.train.train`` at the full published configuration: seeded
    bf16 weights, AdamW, the ``SyntheticLM`` stream, ``batch`` x TRAIN_T
    tokens a step in ``microbatch`` microbatches, ``steps`` steps, launch
    counts from 0 just before and read just after (each step must launch
    the family's forward and backward kernel, ``TRAIN_KERNELS[arch.family]``,
    once a layer and microbatch, and the fused AdamW pass twice). Each step
    is timed
    (host clock to a synchronize) and one traced; the loss must fall as
    ``test_loss_decreases_on_structured_stream`` requires. Then the
    gradient check at the published width cut to 2 layers with batch 1: a
    first step's gradients with the kernels against the same step with the
    plain attention (or scan), leaf by leaf (relative L2), beside the plain
    version's own bf16-vs-fp32 error. Returns the phase's line (the
    loop's launch counts, losses, peak memory and step walls)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod
    from repro_torch.models import get_arch, init_params
    arch = get_arch(arch_name)
    fwd, bwd, entry, plain, body, traced_names = TRAIN_KERNELS[arch.family]
    bodies = lambda: dict(getattr(ops, bwd).launches_by_body)  # noqa: E731
    walls, traced = [], {}   # untraced steps' walls; the traced step's
    allocs = []              # the caching allocator's counters, each step
    make = train_mod.make_train_step

    def alloc_counts():
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in ALLOC_COUNTERS}

    def timed_make(*a, **kw):
        fn = make(*a, **kw)

        def step(*args):
            sync()
            before = alloc_counts()
            try:
                return timed(*args)
            finally:
                after = alloc_counts()
                allocs.append({k: after[k] - before[k] for k in after})

        def timed(*args):
            if len(walls) == TRAIN_TRACE_STEP and not traced:
                (out, wall), busy, split = _device_busy(
                    lambda: fn(*args), split=True,
                    expect=traced_names)
                traced.update(wall_ms=wall * 1e3, device_busy_ms=busy,
                              idle_share=None if busy is None
                              else max(0.0, 1.0 - busy / (wall * 1e3)),
                              device_ms_by_kind=split)
                return out
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            walls.append(time.perf_counter() - t0)
            return out
        return step

    cfg = train_mod.TrainConfig(arch=arch_name, scale="full",
                                steps=steps, global_batch=batch,
                                seq_len=TRAIN_T, microbatch=microbatch,
                                log_every=1, device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_mod.make_train_step = timed_make
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = train_mod.train(cfg, progress=lambda _: None)
        sync()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        by_body = bodies()
        fwd_by_body = dict(getattr(ops.KERNELS[fwd], "launches_by_body", {}))
    finally:
        train_mod.make_train_step = make
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [l for _, l in out["losses"]]
    del out
    torch.cuda.empty_cache()
    per_step = {k: launches[k] / steps for k in (fwd, bwd)}
    tokens = batch * TRAIN_T
    steady = statistics.median(walls[1:])
    line = {"phase": f"train_{arch_name}", "arch": arch_name,
            "layers": arch.n_layers, "params": arch.n_params(),
            "optimizer": "adamw", "steps": steps,
            "global_batch": batch, "microbatch": microbatch,
            "seq_len": TRAIN_T,
            "wall_s": wall, "first_step_s": walls[0],
            "step_s": walls[1:], "step_median_s": steady,
            "note": "first_step_s: step 1; step_s: the other untraced "
                    "steps (host clock to a synchronize); traced_step: "
                    "step TRAIN_TRACE_STEP + 1 under torch.profiler; "
                    "tokens_per_s: over the median step; "
                    "tokens_per_s_window: every untraced step's tokens over "
                    "their summed walls, the first step included; "
                    "allocator_by_step: the caching allocator's counters "
                    "gained in each step, the traced one included",
            "tokens_per_s": tokens / steady,
            "tokens_per_s_window": tokens * len(walls) / sum(walls),
            "allocator_by_step": allocs,
            "traced_step": {"index": TRAIN_TRACE_STEP, **traced},
            "peak_memory_gb": peak_gb, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "forward_launches_by_body": fwd_by_body,
            "backward_launches_by_body": by_body}
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(per_step[fwd] == per_step[bwd] == arch.n_layers * microbatch,
          f"train: {per_step} launches a step, not one forward and one "
          f"backward a layer ({arch.n_layers}) and microbatch ({microbatch})")
    check(by_body[body] == launches[bwd],
          f"train: the backward ran {by_body}, not the {body} body every "
          f"time")
    check(launches["adamw"] == 2 * steps,
          f"train: {launches['adamw']} launches of the fused AdamW pass in "
          f"{steps} steps, not two a step")
    check(min(losses[2:]) < losses[0] - 0.05,
          f"train: the loss did not fall on the structured stream: {losses}")

    # the gradient check: 2 layers of the published width, batch 1, random
    # tokens and labels (a row of the structured stream may repeat one
    # token, and then q and k get no gradient beyond rounding noise)
    small = dataclasses.replace(arch, n_layers=2)
    params = init_params(torch.Generator(device=DEVICE).manual_seed(1), small)
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, small.vocab_size, (1, TRAIN_T))
                                .astype(np.int32), device=DEVICE)
             for k in ("tokens", "labels")}
    ops.reset_launch_counts()
    loss_k, g_kernel = _first_step_grads(small, params, batch)
    grad_launches = ops.launch_counts()
    grad_bodies = bodies()
    kernel_entry = getattr(ops, entry)
    setattr(ops, entry, getattr(ref, plain))
    try:
        loss_p, g_plain = _first_step_grads(small, params, batch)
        loss_32, g_fp32 = _first_step_grads(small, _cast(params, torch.float32),
                                            batch)
    finally:
        setattr(ops, entry, kernel_entry)
    err = _leaf_rel_l2(g_kernel, g_plain)
    witness = _leaf_rel_l2(g_plain, g_fp32)
    limit = {k: max(GRAD_REL_L2_FLOOR, 2 * witness[k]) for k in err}
    bad = {k: (err[k], limit[k]) for k in err if not err[k] <= limit[k]}
    line["grad_check"] = {
        "layers": 2, "batch": 1, "seq_len": TRAIN_T,
        "loss_kernel": loss_k, "loss_plain": loss_p, "loss_plain_fp32": loss_32,
        "launches": {k: grad_launches[k] for k in (fwd, bwd)},
        "plain": f"ops.{entry} = ref.{plain}",
        "kernel_vs_plain_rel_l2_max": max(err.values()),
        "plain_bf16_vs_fp32_rel_l2_max": max(witness.values()),
        "kernel_vs_plain_rel_l2": err,
        "plain_bf16_vs_fp32_rel_l2": witness,
        "limit": f"per leaf max({GRAD_REL_L2_FLOOR}, 2 x the plain "
                 f"version's bf16-vs-fp32 error)",
        "backward_launches_by_body": grad_bodies}
    del g_plain, g_fp32
    torch.cuda.empty_cache()
    try:
        line["update_check"] = _update_check(small, params, batch, g_kernel,
                                             loss_k)
    finally:
        emit(line)
    check(grad_launches[bwd] == 2 and grad_bodies[body] == 2,
          f"grad check: {grad_launches}, {grad_bodies} (one backward a "
          f"layer, on the {body} body)")
    check(not bad, f"train: gradients off the plain {entry}'s: {bad}")
    del params, g_kernel, batch
    torch.cuda.empty_cache()
    return line


class _Dropped:
    """Counts, call by call, the assignments that ``layers.moe_dispatch``
    (no mesh) or ``layers.moe_dispatch_sharded`` (a mesh) drops past their
    expert's capacity, while the ``with`` block runs."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.dropped = layers, []
        self.orig = layers.moe_dispatch, layers.moe_dispatch_sharded

        def wrap(fn, keep_at):
            def counted(*args, **kw):
                out = fn(*args, **kw)
                self.dropped.append(int((~out[keep_at]).sum()))
                return out
            return counted
        layers.moe_dispatch = wrap(self.orig[0], 3)
        layers.moe_dispatch_sharded = wrap(self.orig[1], 3)
        return self

    def __exit__(self, *exc):
        self.layers.moe_dispatch, self.layers.moe_dispatch_sharded = self.orig


def phase_train_remat(arch_name: str, batch: int, unpolicied=None,
                      strategy: str = "fsdp_tp", layers=None):
    """Training under a sharding policy with remat: a 1x1 mesh of the card
    (``launch.mesh.card_group``, a one-rank NCCL group),
    ``make_policy(mesh, strategy=strategy, remat="full")`` and
    ``launch.specs.make_train_step``, the parameters, optimizer state and
    batches DTensors placed by ``param_specs`` / ``batch_specs``: the
    published configuration (with ``layers``, its width cut to that many
    layers), ``batch`` x TRAIN_T tokens a step at once (no microbatches),
    TRAIN_REMAT_STEPS steps of the ``SyntheticLM`` stream from the seeds
    ``train`` uses. Launch counts from 0 just before the steps and read
    just after: a step launches the forward kernel twice a layer (forward,
    then the recompute) and the backward once, every backward on its
    family's tensor-core body. Then ``_step_ms`` times and traces more
    steps (busy and idle share). ``unpolicied`` is the line of the same
    architecture's ``phase_train``: its first loss (same seed, same first
    batch) and its peak memory and step walls sit beside this phase's.
    Without one (an MoE model too large to train unpolicied beside it), an
    unpolicied ``loss_fn`` on the same parameters and first batch gives the
    loss the first step's is held to, and the assignments each MoE layer
    drops past capacity in that forward and in the first step's are
    counted (``_Dropped``). Returns the line."""
    import torch
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import card_group, make_mesh
    from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                             make_policy, param_specs)
    from repro_torch.launch.specs import make_optimizer, make_train_step
    from repro_torch.models import get_arch, init_params, loss_fn
    from repro_torch.optim import tree_map
    arch = get_arch(arch_name)
    reduced = []
    if layers is not None:
        reduced.append(f"n_layers {arch.n_layers} -> {layers}")
        arch = dataclasses.replace(arch, n_layers=layers)
    fwd, bwd, _, _, body, _ = TRAIN_KERNELS[arch.family]
    steps = TRAIN_REMAT_STEPS
    source = SyntheticLM(PipelineConfig(global_batch=batch, seq_len=TRAIN_T,
                                        vocab_size=arch.vocab_size, seed=0))

    def alloc_counts():
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in ALLOC_COUNTERS}

    torch.cuda.empty_cache()
    plain = None
    with card_group():
        mesh = make_mesh((1, 1), ("data", "model"))
        policy = make_policy(mesh, strategy=strategy, remat="full")

        def batch_at(i):
            b = {k: torch.from_numpy(v.copy()).to(DEVICE)
                 for k, v in source.batch(i).items()}
            return distribute_tree(mesh, batch_specs(mesh, b), b)
        params = init_params(torch.Generator(device=DEVICE).manual_seed(0),
                             arch)
        params = distribute_tree(
            mesh, param_specs(params, arch, mesh, strategy), params)
        n_params = sum(t.numel() for t in _leaves(params))
        if unpolicied is None:
            # the same parameters and batch, no policy: on a 1x1 mesh each
            # DTensor's local tensor is the whole tensor
            b = batch_at(0)
            with torch.no_grad(), _Dropped() as seen:
                plain = float(loss_fn(tree_map(lambda t: t.to_local(), params),
                                      arch, {k: v.to_local()
                                             for k, v in b.items()}))
            plain_dropped = seen.dropped
        optimizer = make_optimizer(arch, total_steps=steps)
        opt = optimizer.init(params)
        step_fn = make_train_step(arch, policy, optimizer)
        sync()
        torch.cuda.reset_peak_memory_stats()
        walls, allocs, losses = [], [], []
        ops.reset_launch_counts()
        for i in range(steps):
            b = batch_at(i)
            sync()
            before = alloc_counts()
            t0 = time.perf_counter()
            if i == 0:
                with _Dropped() as seen:
                    params, opt, _, metrics = step_fn(params, opt, i, b)
                # the forward's calls, one a MoE layer, then the recompute's
                step_dropped = seen.dropped[:len(seen.dropped) // 2]
            else:
                params, opt, _, metrics = step_fn(params, opt, i, b)
            sync()
            walls.append(time.perf_counter() - t0)
            after = alloc_counts()
            allocs.append({k: after[k] - before[k] for k in after})
            losses.append(float(metrics["loss"]))
        launches = ops.launch_counts()
        by_body = dict(getattr(ops, bwd).launches_by_body)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        traced = _step_ms(lambda: step_fn(params, opt, steps, b), reps=2,
                          calls=1)
        del params, opt, b, metrics
    torch.cuda.empty_cache()
    per_step = {k: launches[k] / steps for k in (fwd, bwd)}
    tokens = batch * TRAIN_T
    steady = statistics.median(walls[1:])
    line = {"phase": f"train_remat_{arch_name}", "arch": arch_name,
            "layers": arch.n_layers, "reduced": reduced,
            "d_model": arch.d_model, "params": n_params, "mesh": [1, 1],
            "policy": policy.describe(), "steps": steps,
            "global_batch": batch, "microbatch": 1, "seq_len": TRAIN_T,
            "first_step_s": walls[0], "step_s": walls[1:],
            "step_median_s": steady, "tokens_per_s": tokens / steady,
            "traced_steps": traced, "allocator_by_step": allocs,
            "peak_memory_gb": peak_gb, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "backward_launches_by_body": by_body,
            "note": "peak_memory_gb: from after the parameters and optimizer "
                    "state are placed, over the TRAIN_REMAT_STEPS steps; "
                    "traced_steps: _step_ms over more steps of the same "
                    "batch (wall median of 2, one traced)"}
    if unpolicied is not None:
        line.update({
            "unpolicied": {k: unpolicied[k] for k in (
                "global_batch", "microbatch", "step_median_s",
                "tokens_per_s", "peak_memory_gb")},
            "unpolicied_first_loss": unpolicied["losses"][0],
            "first_loss_rel_diff": abs(losses[0] - unpolicied["losses"][0])
            / abs(unpolicied["losses"][0])})
        line["note"] += "; unpolicied: the same architecture's train_ phase " \
                        "in this run"
    else:
        line.update({
            "unpolicied_loss_fn": plain,
            "first_loss_rel_diff": abs(losses[0] - plain) / abs(plain),
            "first_loss_bit_equal": losses[0] == plain,
            "moe_overflowing_assignments": {"policy": step_dropped,
                                            "unpolicied": plain_dropped},
            "experts": arch.n_experts, "top_k": arch.top_k,
            "capacity_factor": arch.capacity_factor})
        line["note"] += "; unpolicied_loss_fn: loss_fn without a policy on " \
                        "the first step's parameters and batch"
    emit(line)
    check(all(math.isfinite(x) for x in losses), f"remat: losses {losses}")
    check(per_step[fwd] == 2 * arch.n_layers and
          per_step[bwd] == arch.n_layers,
          f"remat: {per_step} launches a step, not two forwards (forward, "
          f"recompute) and one backward a layer ({arch.n_layers})")
    check(by_body[body] == launches[bwd],
          f"remat: the backward ran {by_body}, not the {body} body every "
          f"time")
    if unpolicied is None:
        check(line["first_loss_rel_diff"] <= TRAIN_MOE_TOL,
              f"remat: first loss {losses[0]} off the unpolicied loss_fn's "
              f"{plain} by more than {TRAIN_MOE_TOL} relative")
        check(step_dropped == plain_dropped and len(plain_dropped) ==
              arch.n_layers - arch.n_dense_layers,
              f"remat: MoE layers dropped {step_dropped} assignments under "
              f"the policy, {plain_dropped} without")
    return line


def phase_train_resume(arch_name: str, root: Path) -> None:
    """The failure drill of ``test_failure_injection_and_bitwise_resume`` on
    the card, at the published width cut to 2 layers (a configuration of
    its own, registered for the drill): 12 steps with checkpoints every 5,
    a crash at step 7, a restart from the step-5 checkpoint; the resumed
    parameters must equal an uninterrupted run's bit for bit. Checkpoints
    go to a directory under the checkout's ``build/``, removed afterwards.
    The loop's checkpointer is wrapped to time each save (made blocking,
    so the time is the whole write) and the resume's restore."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import arch as arch_mod
    from repro_torch.models import get_arch
    from repro_torch.optim import tree_leaves
    times = {"save": [], "restore": []}

    class Timed(train_mod.Checkpointer):
        def save(self, step, tree, extras=None, block=False):
            sync()
            t0 = time.perf_counter()
            super().save(step, tree, extras, block=True)
            times["save"].append(time.perf_counter() - t0)

        def restore(self, template, step=None):
            t0 = time.perf_counter()
            out = super().restore(template, step)
            sync()
            times["restore"].append(time.perf_counter() - t0)
            return out

    name = f"{arch_name}-2-layers"
    arch_mod.register_arch(dataclasses.replace(get_arch(arch_name), name=name,
                                               n_layers=2))
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="train_resume_", dir=root / "build"))
    checkpointer = train_mod.Checkpointer
    train_mod.Checkpointer = Timed
    try:
        common = dict(arch=name, scale="full", steps=12,
                      global_batch=TRAIN_BATCH, seq_len=TRAIN_T, ckpt_every=5,
                      log_every=100, device=DEVICE)
        quiet = lambda _: None   # noqa: E731
        t0 = time.perf_counter()
        ref = train_mod.train(train_mod.TrainConfig(
            **common, ckpt_dir=str(tmp / "ref")), quiet)
        t_ref = time.perf_counter() - t0
        step5 = tmp / "ref" / "step_00000005"
        nbytes = sum(f.stat().st_size for f in step5.iterdir()) \
            if step5.is_dir() else None
        crashed = False
        try:
            train_mod.train(train_mod.TrainConfig(
                **common, ckpt_dir=str(tmp / "crash"), fail_at=7), quiet)
        except RuntimeError as e:
            crashed = "injected failure" in str(e)
        seen = []
        t0 = time.perf_counter()
        resumed = train_mod.train(train_mod.TrainConfig(
            **common, ckpt_dir=str(tmp / "crash")), seen.append)
        t_resumed = time.perf_counter() - t0
        la, lb = tree_leaves(ref["params"]), tree_leaves(resumed["params"])
        same = len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))
        n_diff = sum(int((x != y).sum()) for x, y in zip(la, lb))
        emit({"phase": "train_resume", "arch": arch_name,
              "reduced": {"n_layers": [get_arch(arch_name).n_layers, 2]},
              "steps": 12, "ckpt_every": 5, "fail_at": 7,
              "global_batch": TRAIN_BATCH, "seq_len": TRAIN_T,
              "crashed": crashed, "resume_log": seen[:1],
              "final_step": resumed["final_step"],
              "bit_identical": same, "elements_differing": n_diff,
              "uninterrupted_wall_s": t_ref, "resumed_wall_s": t_resumed,
              "checkpoint_bytes": nbytes, "save_s": times["save"],
              "restore_s": times["restore"],
              "note": "save_s: every save of the three runs, each made "
                      "blocking (host copy and write); restore_s: the "
                      "resume's"})
        check(crashed, "train_resume: the run did not crash at step 7")
        check(seen[:1] == ["[resume] step 5"],
              f"train_resume: resumed from {seen[:1]}, not step 5")
        check(resumed["final_step"] == 12, "train_resume: final step")
        check(same, f"train_resume: {n_diff} parameter elements differ from "
                    f"the uninterrupted run")
    finally:
        train_mod.Checkpointer = checkpointer
        shutil.rmtree(tmp, ignore_errors=True)
        arch_mod._REGISTRY.pop(name, None)
        torch.cuda.empty_cache()
    check(not tmp.exists(), f"train_resume: {tmp} left behind")


def phase_planner() -> None:
    """One step plan of the Cobra session's planner facade under the port's
    default hardware table (one H100 SXM): the cell the minicpm3 phase
    serves (4 sequences of 4,608 slots, prefill) on a one-card mesh."""
    from repro_torch.analysis.roofline import HW
    from repro_torch.api import CobraSession
    from repro_torch.programs import make_orders_customer_db
    session = CobraSession(make_orders_customer_db(10, 10, device=DEVICE))
    t0 = time.perf_counter()
    rep = session.plan_step("minicpm3-4b", MAX_SEQ, len(PROMPT_LENS),
                            "prefill", mesh=(1, 1, 1))
    wall_s = time.perf_counter() - t0
    check(rep.domain == "step" and rep.alternatives > 0
          and math.isfinite(rep.est_cost_s),
          f"plan_step gave no feasible plan: {rep}")
    check(session.plan_step("minicpm3-4b", MAX_SEQ, len(PROMPT_LENS),
                            "prefill", mesh=(1, 1, 1)) is rep,
          "plan_step did not memoize the cell")
    emit({"phase": "planner", "cell": rep.name, "mesh": [1, 1, 1],
          "hw": dict(HW), "choice": dataclasses.asdict(rep.choice),
          "est_cost_s": rep.est_cost_s, "alternatives": rep.alternatives,
          "terms": rep.artifact, "memo": rep.memo_stats, "wall_s": wall_s})


EXAMPLES = ("quickstart", "serve_programs", "plan_distributed", "serve_lm",
            "train_lm")


def phase_examples(root: Path) -> None:
    """Each example's twin (``examples/<name>_torch.py``) through its
    ``main()`` on the card, as a user runs it (its printed lines captured):
    one line a twin with its wall time, the kernel launches it made and
    the figures it returns, then what the reference example checks.
    quickstart: identical results in every program, a plan-cache hit, and
    the join/prefetch flip after ``analyze()``; serve_programs: 0 memo runs
    in session B, the drift flip from join to prefetch, the compiled
    tier's outputs equal to the interpreter's, the hot shard flagged;
    plan_distributed: three reports a cell; serve_lm: every request's 24
    tokens; train_lm: finite losses that fall over the default 200 steps
    (its checkpoints in a directory removed after)."""
    import contextlib
    import importlib.util
    import io
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    figures = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch", root / "examples" / f"{name}_torch.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = []
        if name == "train_lm":
            ckpt = tempfile.mkdtemp(prefix="train_lm_")
            argv = ["--ckpt-dir", ckpt]
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fig = mod.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in ops.launch_counts().items() if n}
        if name == "train_lm":
            shutil.rmtree(ckpt, ignore_errors=True)
        figures[name] = fig
        if name == "serve_lm":
            fig = {k: v for k, v in fig.items() if k != "completions"}
        emit({"phase": f"example_{name}", "wall_s": wall,
              "printed_lines": len(out.getvalue().splitlines()),
              "launches": launches, "figures": fig})

    qs = figures["quickstart"]
    check(all(c["identical"] and c["cache_hits"] >= 1 for c in qs["cells"]),
          f"quickstart: {qs['cells']}")
    check(qs["analyze_flip"]["flipped"] and qs["analyze_flip"]["recompiled"],
          f"quickstart: no join/prefetch flip after analyze(): "
          f"{qs['analyze_flip']}")
    sp = figures["serve_programs"]
    check(sp["store"]["session_b_memo_runs"] == 0,
          f"serve_programs: session B ran {sp['store']}")
    check(sp["drift"]["p0_prefetch"], f"serve_programs: {sp['drift']}")
    ct = sp["compiled_tier"]
    check(ct["identical"] and ct["tiers"][0] == "interpreter"
          and ct["tiers"][-1] == "compiled", f"serve_programs: {ct}")
    check(sp["cluster"]["hot_shard_requests"] == 48,
          f"serve_programs: {sp['cluster']}")
    check(all(len(r) == 3 for r in figures["plan_distributed"].values()),
          "plan_distributed: not three reports a cell")
    lm = figures["serve_lm"]
    check(lm["new_tokens"] == lm["requests"] * 24 and
          all(len(c) == 24 for c in lm["completions"]),
          f"serve_lm: {lm['new_tokens']} tokens")
    tr = figures["train_lm"]
    check(tr["finite"] and tr["last_loss"] < tr["first_loss"],
          f"train_lm: loss {tr['first_loss']} -> {tr['last_loss']}")


def _by_kind(events, calls: int = 1) -> dict:
    """The device ms a call of a trace's activities, by the harness's
    pieces (``bench.tracing``): the port's hand-written LM kernels, cuBLAS's
    products, and the rest (the eager ops, copies and fills, the relational
    kernels); overlapping activities each count in full. ``top_ms`` names
    the five that took most (``breakdown``), so the split can be read and
    corrected."""
    from bench.tracing import GEMM, HAND_WRITTEN, breakdown, is_eager, time_in
    top = breakdown([{"name": "", "events": events}], top=5)["device_ops"]
    return {"hand_written_ms": time_in(events, HAND_WRITTEN) * 1e3 / calls,
            "gemm_ms": time_in(events, GEMM) * 1e3 / calls,
            "rest_ms": sum(b - a for n, a, b in events if is_eager(n))
            / 1e3 / calls,
            "top_ms": [[n, t * 1e3 / calls] for n, t in top]}


def _device_busy(fn, split: bool = False, expect: tuple = ()):
    """``((fn(), wall seconds), device busy ms)``: one call under a trace
    of the card's activity (``bench.tracing.Session``: opened over a
    warm-up step of small kernels, ended by a synchronize; ``fn`` runs
    once, as its caller's state needs, so the trace is not tried again).
    Busy is None ("not measured") where the trace holds no device activity
    or no kernel whose name holds a piece of ``expect``. With ``split``,
    also the device time by kind (``_by_kind``), which then lists what
    keeps the trace from being whole under "faults"."""
    from bench.tracing import Session, busy_s, faults_of
    trace = Session(DEVICE)
    out = fn()
    wall, events = trace.close()
    faults = faults_of(events, 1, {}, False) + [
        f"missing {x}" for x in expect
        if not any(x in n for n, _, _ in events)]
    busy = None if faults else (busy_s(events) * 1e3 or None)
    if split:
        by_kind = _by_kind(events)
        if faults:
            by_kind["faults"] = faults
        return (out, wall), busy, by_kind
    return (out, wall), busy


def _step_ms(fn, reps: int = 3, calls: int = 2):
    """One model step's (or hook call's) wall time and the device's busy
    time within it.

    ``wall_ms``: host clock around the call and a synchronize (median of
    ``reps``), as a caller sees it. ``device_busy_ms``: the union of the
    intervals in which a ``torch.profiler`` trace of ``calls`` more calls
    saw the card run a kernel, copy or fill (``bench.tracing.busy_s``),
    over ``calls``, split by ``_by_kind`` in ``device_ms_by_kind``. The
    profiler's warm-up step runs ``fn`` for ``TRACE_WARM_S`` seconds, and
    a trace is held only where ``bench.tracing.faults_of`` finds every
    name a multiple of ``calls`` (a call launches the same work each
    time). After ``TRACE_TRIES`` traces that are not, the readings of the
    trace are None ("not measured") and ``trace_note`` gives the last
    trace's faults. The idle share is the part of the wall time the card
    ran nothing. The host's op events, which nothing here reads, make
    parsing the trace of a host-bound prefill slow (zamba2's 34,000 ops a
    call: about a minute with the tries), but without them that trace
    missed kernels in one run of two."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from bench.tracing import (TRACE_TRIES, TRACE_WARM_S, busy_s,
                               device_events, faults_of)
    fn()
    sync()
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    w = statistics.median(wall)
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < TRACE_WARM_S:
                fn()
            sync()
            prof.step()
            for _ in range(calls):
                fn()
            sync()
            prof.step()
        events = device_events(prof)
        faults = faults_of(events, calls, {}, True)
        busy = busy_s(events) * 1e3 / calls
        if not faults and busy:
            return {"wall_ms": w, "device_busy_ms": busy,
                    "idle_share": max(0.0, 1.0 - busy / w),
                    "device_events": len(events) // calls,
                    "device_ms_by_kind": _by_kind(events, calls)}
    return {"wall_ms": w, "device_busy_ms": None, "idle_share": None,
            "device_events": None, "device_ms_by_kind": None,
            "trace_note": f"{TRACE_TRIES} traces of {calls} calls, none "
                          f"whole: {faults[:8]} in the last"}


def _cast(tree, dtype):
    """A parameter tree with every leaf cast to ``dtype`` (a copy)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    # the port; the kernels' tolerances (tests/_torch_cases.py); the
    # harness's trace pieces (bench/tracing.py) under the checkout's root
    sys.path[:0] = [str(src), str(root / "tests"), str(root)]
    # no TF32 anywhere: the plain versions run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = phase_device()
    phase_build()

    from repro_torch.kernels import ops
    from repro_torch.programs import make_orders_customer_db
    t0 = time.perf_counter()
    order_db = make_orders_customer_db(N_ORDERS, N_CUSTOMERS, device=DEVICE)
    sync()
    emit({"phase": "database", "orders": N_ORDERS, "customers": N_CUSTOMERS,
          "build_and_analyze_s": time.perf_counter() - t0})

    # the relational main path: launch counts from 0 just before it, read
    # just after
    ops.reset_launch_counts()
    main_out = phase_main_path(order_db)
    nav_loop = phase_navigation(order_db, main_out)
    wilos_db, fold_outs, fold_loop = phase_fold()
    launches = ops.launch_counts()
    missing = [k for k in RELATIONAL if launches[k] == 0]
    check(not missing,
          f"kernels never launched on the main path: {missing}")
    phase_hooks(order_db, wilos_db, nav_loop, fold_loop)

    # the serving loop and the cluster, each with its counts from 0
    phase_serving(order_db, wilos_db, main_out, fold_outs)
    phase_cluster(wilos_db)
    del order_db, wilos_db, fold_outs, main_out, nav_loop, fold_loop

    # the LM serving paths, each with its counts from 0 (inside phase_serve)
    missing = []
    for arch, kernel, entry, layers in SERVES:
        if phase_serve(arch, kernel, entry, layers=layers) == 0:
            missing.append(f"{kernel} ({arch})")
    check(not missing,
          f"kernels never launched on the serving paths: {missing}")
    # training, each loop with its counts from 0 (inside phase_train)
    danube = phase_train(TRAIN_ARCH)
    check(danube["launches"]["flash_attention_bwd"] > 0,
          "flash_attention_bwd never launched on the training path")
    phase_train_resume(TRAIN_ARCH, root)
    rwkv = phase_train(TRAIN_RWKV_ARCH, batch=TRAIN_RWKV_BATCH,
                       steps=TRAIN_RWKV_STEPS,
                       microbatch=TRAIN_RWKV_MICROBATCH)
    check(rwkv["launches"]["rwkv6_scan_bwd"] > 0,
          "rwkv6_scan_bwd never launched on the training path")
    # the same two under a sharding policy with remat
    remat = phase_train_remat(TRAIN_ARCH, TRAIN_BATCH, danube)
    check(remat["losses"][0] == danube["losses"][0],
          f"remat: first loss {remat['losses'][0]} != the unpolicied "
          f"phase's {danube['losses'][0]} (same seed and batch)")
    check(remat["peak_memory_gb"] < danube["peak_memory_gb"],
          f"remat: peak {remat['peak_memory_gb']} GB not below the "
          f"unpolicied phase's {danube['peak_memory_gb']} GB")
    remat = phase_train_remat(TRAIN_RWKV_ARCH, TRAIN_RWKV_BATCH, rwkv)
    check(remat["first_loss_rel_diff"] <= TRAIN_REMAT_RWKV_TOL,
          f"remat: first loss {remat['losses'][0]} off the microbatched "
          f"phase's {rwkv['losses'][0]} by more than "
          f"{TRAIN_REMAT_RWKV_TOL} relative")
    # the MoE layer under a policy (its checks inside)
    phase_train_remat(TRAIN_MOE_ARCH, TRAIN_MOE_BATCH,
                      strategy="fsdp_tp_ep", layers=TRAIN_MOE_LAYERS)
    phase_planner()
    phase_examples(root)
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
