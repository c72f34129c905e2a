#!/usr/bin/env python3
"""Time the relational kernels of two checkouts in turns, on one NVIDIA GPU.

    python3 chip_kernel_ab.py OTHER [--rounds R]
                              [--attention [--arch NAME ... | --cells]
                               | --attention-bwd
                               | --scan-bwd | --adamw]

OTHER is another checkout of the repository (for instance the parent
commit, unpacked with ``git archive`` into a git-ignored directory). The
script runs R rounds of four turns, OTHER, this checkout, this checkout,
OTHER, each in a process of its own that imports ``repro_torch`` from that
checkout's ``src`` and builds its kernels there; both sides are timed by
this script's timer (``_Timer``) and read with this checkout's
``chip_smoke.py``, ``bench/tracing.py`` and ``tests/_torch_cases.py`` (the
kernels' tolerances). Every turn makes the same seeded inputs at the shapes
of ``chip_smoke.py``'s main path (2,880,404 probe keys over 100,000 slots;
2,880,404 fold values), holds each kernel against its plain version
(exact), and times ``join_probe``, ``build_direct_table`` (over a
permutation and over keys in row order) and ``segment_reduce`` at G = 1
and G = 600 (CUDA events, L2 flushed before each launch, median of 50),
plus the device time of each kernel a call launches (``_kernel_ms``).
Prints one JSON line per turn, the card's name and power limit, and a
summary line
``{"ab": {kernel: {"other": [[ms, clean_ms, call_ms], ...], "this":
[...]}}}`` (``clean_ms``: the same timer flushing by a read, so the L2 holds
no dirty lines to write back; ``call_ms``: with the wrapper's host time). Exits
non-zero if a turn fails. Imports nothing of JAX.

With ``--attention`` the turns time ``flash_attention`` instead, at the
serving shapes of ``chip_smoke.py``'s serve phases through it (each
``--arch``, by default all of ``ATTENTION_ARCHS``): its 4 sequences'
4,500-token prefill and one decode step over 4,531 slots, bf16 queries over
the fp32 cache, both read through their serving layouts, each held to the
plain version within ``ATTN_KERNEL_TOL``. The heads come from the
architecture: h2o-danube-1.8b (32 over 8 KV heads, hd 80, window 4,096;
the cache holds bf16 values), qwen2-vl-72b (64 over 8, hd 128) and
minicpm3-4b (MLA: 40 heads, q.k hd 96 = 64 + 32 with the rope key shared
by the heads, v hd 64 a strided slice of the expanded latent, which holds
fp32 values). Entries are named ``ARCH_prefill`` and ``ARCH_decode``.

With ``--attention --cells`` the turns time ``flash_attention`` at the
benchmark cells' own calls instead (seeded inputs drawn on the card, the
serving layouts): ``danube-serve-docqa_prefill`` (16 x 4,001 tokens, H 32
/ KV 8, hd 80, window 4,096, bf16 q over the fp32 cache holding bf16
values), ``minicpm3-serve-longdoc_prefill`` (2 x 15,012, H = KV = 40, hd
96 / hdv 64 over random fp32 K/V, v a strided slice) and
``danube-train-4x2048_forward`` (4 x 2,048, bf16 q, k, v, the rows'
log-sum-exps written, as the training forward calls it). Each is held to
the plain version on its last 64 queries within ``ATTN_KERNEL_TOL``
(the whole call's plain scores would not fit the card), the log-sum-exps
within 1e-4; ``bodies`` gives the counts by body of a checkout that keeps
them.

With ``--attention-bwd`` the turns time ``flash_attention_bwd`` instead, at
the shapes of ``TRAIN_KERNEL_SHAPES``: danube's training call
(4 x 2,048, H 32 / KV 8, hd 80, causal, window 4,096), and qwen2-vl's (H 64
/ KV 8, hd 128) and stablelm's (H 32 / KV 8, hd 160) at 1 x 2,048, causal,
over seeded bf16 inputs with the plain version's output and log-sum-exps
(so no turn builds the forward kernel). Each is held to the plain version
in fp32 within ``BWD_TOL`` of its peak. Entries are named by the
architecture.

With ``--scan-bwd`` the turns time ``rwkv6_scan_bwd`` instead, at
rwkv6-3b's training call (1 x 2,048 tokens, H 40, K = V = 64, bf16 r, k,
v and dy, no state; ``_torch_cases.scan_bwd_inputs``' seeded inputs and
the forward kernel's chunk states and decays, each checkout's own), with
each checkout's body for it, held to the plain version in fp32: dr, dk,
dv within ``BWD_TOL`` of their peak in bf16, dw and du within its fp32
limit. The entry is named
``rwkv6-3b_train``; ``kernel_ms`` splits each turn's call by kernel.

With ``--adamw`` the turns time the train step's optimizer (the clip to a
global norm of 1.0, AdamW, the apply) as each checkout's
``make_train_step`` runs it on the card, over h2o-danube-1.8b's 195 leaves
(1.83 B parameters: bf16 matrices, fp32 norms, gradients of the
parameters' types, seeded; the clip engaged): the eager ops, or where the
checkout has ``kernels.adamw`` its fused pass (``Optimizer.fused``: the
norm, the scale, the update), whose ``kernel_ms`` splits the two kernels. A
checkout with the fused pass also times its eager path (``eager``), and
holds the fused pass to it at that size given the same norm (m, v and p
bit-identical) and the norm to an fp64 one (``norm_rel_err``). The entry is
named ``h2o-danube-1.8b_optimizer``.
"""

import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ENTRIES = ("join_probe", "build_direct_table", "build_direct_table_sorted",
           "segment_reduce", "segment_reduce_g600")
ATTENTION_ARCHS = ("h2o-danube-1.8b", "qwen2-vl-72b", "minicpm3-4b")
# flash_attention_bwd's timed shapes: danube's training call (4 x 2,048),
# and the widest heads' (hd 128, hd 160) at 1 x 2,048: (arch, batch)
TRAIN_KERNEL_SHAPES = (("h2o-danube-1.8b", 4), ("qwen2-vl-72b", 1),
                       ("stablelm-12b", 1))
TIMED_LAUNCHES = 50


def _on_path(src: str) -> None:
    """A turn's imports: ``repro_torch`` from ``src``; ``chip_smoke``,
    ``bench`` and ``_torch_cases`` from this checkout."""
    sys.path[:0] = [src, str(HERE), str(HERE / "tests")]


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
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, hold: bool = True, reps: int = TIMED_LAUNCHES,
           clean: bool = False) -> float:
        """``clean``: flush by reading the 128 MB buffer, not writing it, so
        the L2 holds clean lines and the call's misses write nothing back
        (the write flush leaves ~50 MB of dirty lines, whose write-back a
        streaming call pays for as it evicts them)."""
        import torch
        from bench.tracing import TRACE_WARM_S
        # warm up: 3 calls, or fewer where they outlast TRACE_WARM_S (the
        # plain versions that take a second)
        t0, n = time.perf_counter(), 0
        while n < 3 and (n == 0 or time.perf_counter() - t0 < TRACE_WARM_S):
            fn()
            n += 1
        times = []
        for _ in range(reps):
            if clean:
                torch.amax(self.flush)
            else:
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


def _kernel_ms(fn, reps: int = 5) -> dict:
    """``{"kernel_ms": {name: ms}}``: device time per call of each kernel
    that ``fn`` launches, by ``bench.tracing.kernel_name``, from a
    ``torch.profiler`` trace of ``reps`` calls. The profiler's warm-up step
    runs ``fn`` for ``TRACE_WARM_S`` seconds before the ``reps`` calls it
    keeps, and a trace is held only where ``bench.tracing.faults_of`` finds
    every name a multiple of ``reps``. After ``TRACE_TRIES`` traces that are
    not, ``kernel_ms`` is None ("not measured") and ``kernel_ms_note`` gives
    the last trace's faults."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from bench.tracing import (TRACE_TRIES, TRACE_WARM_S, device_events,
                               faults_of)
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            t0, n = time.perf_counter(), 0
            while n < 3 or time.perf_counter() - t0 < TRACE_WARM_S:
                fn()
                n += 1
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = device_events(prof)
        faults = faults_of(events, reps, {}, True)
        if not faults:
            out = {}
            for name, a, b in events:
                out[name] = out.get(name, 0.0) + (b - a) / reps / 1e3
            return {"kernel_ms": out}
    return {"kernel_ms": None,
            "kernel_ms_note": f"{TRACE_TRIES} traces of {reps} calls, none "
                              f"whole: {faults[:8]}"}


def _bwd_inputs(B, H, KV, Tq, Tk, hd, hdv, seed):
    """Seeded bf16 q, k, v and an output gradient on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    def n(*s):
        return torch.randn(s, generator=g, device="cuda").bfloat16()
    return n(B, H, Tq, hd), n(B, KV, Tk, hd), n(B, KV, Tk, hdv), \
        n(B, H, Tq, hdv)


def _rel_peak(got, want) -> float:
    """max |got - want| over the peak of |want|."""
    d = float((got.float() - want.float()).abs().max())
    return d / max(float(want.float().abs().max()), 1e-30)


def attention_calls(arch_name: str, normal):
    """``{ARCH_call: (q, k, v, kwargs)}`` for one serve phase's prefill and
    last decode step, in the layouts its attention layer passes."""
    import torch
    import chip_smoke as cs
    from repro_torch.models import get_arch
    arch = get_arch(arch_name)
    B, H, S = len(cs.PROMPT_LENS), arch.n_heads, cs.MAX_SEQ
    T = max(cs.PROMPT_LENS)
    calls = {}
    if arch.attn_kind == "mla":
        nope, rdim, vhd = arch.qk_nope_dim, arch.qk_rope_dim, arch.vhd
        for call, Tq, Tk in (("prefill", T, T),
                             ("decode", 1, T + cs.NEW_TOKENS - 1)):
            q = normal(B, Tq, H, nope + rdim).bfloat16().transpose(1, 2)
            kv = normal(B, Tk, H, nope + vhd)
            rope = normal(B, Tk, 1, rdim).bfloat16().float()
            k = torch.cat([kv[..., :nope], rope.expand(B, Tk, H, rdim)],
                          dim=-1).transpose(1, 2)
            calls[f"{arch_name}_{call}"] = (
                q, k, kv[..., nope:].transpose(1, 2),
                {"scale": 1.0 / (nope + rdim) ** 0.5})
        return calls
    KV, hd = arch.n_kv_heads, arch.hd
    cache = normal(2, B, S, KV, hd).bfloat16().float()
    for call, Tq, Tk in (("prefill", T, T), ("decode", 1, T + cs.NEW_TOKENS - 1)):
        calls[f"{arch_name}_{call}"] = (
            normal(B, Tq, H, hd).bfloat16().transpose(1, 2),
            cache[0, :, :Tk].transpose(1, 2), cache[1, :, :Tk].transpose(1, 2),
            {"window": arch.window})
    return calls


def attention_turn(src: str, archs) -> dict:
    """One turn of ``--attention``, in this process."""
    _on_path(src)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    build.build_all(("flash_attention",))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)
    calls = {}
    for arch_name in archs:
        for name, (q, k, v, kw) in attention_calls(arch_name, normal).items():
            calls[name] = (
                lambda q=q, k=k, v=v, kw=kw: ops.attention(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.flash_attention_ref(q, k, v,
                                                                     **kw))
    timer = _Timer()
    out = {"src": src}
    for name, (fn, plain) in calls.items():
        cs.attention_close(fn(), plain(), f"{src}: {name}")
        out[name] = {"ms": timer.ms(fn), "clean_ms": timer.ms(fn, clean=True),
                     "call_ms": timer.ms(fn, hold=False), **_kernel_ms(fn)}
    return out


CELL_CALLS = ("danube-serve-docqa_prefill", "minicpm3-serve-longdoc_prefill",
              "danube-train-4x2048_forward")


def cell_calls(dev):
    """``{name: (q, k, v, kwargs, with_lse)}`` for the benchmark cells'
    attention calls, in the layouts their layers pass."""
    import torch
    g = torch.Generator(device=dev).manual_seed(29)

    def normal(*shape):
        return torch.randn(*shape, device=dev, generator=g)
    B, T, H, KV = 16, 4001, 32, 8
    cache = normal(2, B, 4096, KV, 80).bfloat16().float()
    calls = {"danube-serve-docqa_prefill": (
        normal(B, T, H, 80).bfloat16().transpose(1, 2),
        cache[0, :, :T].transpose(1, 2), cache[1, :, :T].transpose(1, 2),
        {"window": 4096}, False)}
    B, T, H = 2, 15012, 40
    kv = normal(B, T, H, 128)
    k = torch.cat([kv[..., :64], normal(B, T, 1, 32).expand(B, T, H, 32)],
                  dim=-1).transpose(1, 2)
    calls["minicpm3-serve-longdoc_prefill"] = (
        normal(B, T, H, 96).bfloat16().transpose(1, 2), k,
        kv[..., 64:].transpose(1, 2), {"scale": 96 ** -0.5}, False)
    B, T, H, KV = 4, 2048, 32, 8
    calls["danube-train-4x2048_forward"] = tuple(
        normal(B, T, h, 80).bfloat16().transpose(1, 2)
        for h in (H, KV, KV)) + ({"window": 4096}, True)
    return calls


def attention_cells_turn(src: str) -> dict:
    """One turn of ``--attention --cells``, in this process."""
    _on_path(src)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    build.build_all(("flash_attention",))
    dev = torch.device("cuda")
    timer = _Timer()
    out = {"src": src}
    for name, (q, k, v, kw, with_lse) in cell_calls(dev).items():
        def fn(q=q, k=k, v=v, kw=kw, with_lse=with_lse):
            if with_lse:
                return fa._forward(q, k, v, True, kw.get("window"), None,
                                   q.shape[3] ** -0.5, with_lse=True)
            return ops.attention(q, k, v, **kw), None
        before = dict(getattr(fa.flash_attention, "launches_by_body", {}))
        got, lse = fn()
        bodies = {b: n - before[b] for b, n in
                  getattr(fa.flash_attention, "launches_by_body", {}).items()
                  if n != before[b]}
        want = ref.flash_attention_ref(q[:, :, -64:], k, v,
                                       return_lse=with_lse, **kw)
        if with_lse:
            want, want_lse = want
            torch.testing.assert_close(lse[:, :, -64:], want_lse, rtol=1e-5,
                                       atol=1e-4)
        err = cs.attention_close(got[:, :, -64:], want, f"{src}: {name}")
        out[name] = {"ms": timer.ms(lambda: fn(), reps=10),
                     "clean_ms": timer.ms(lambda: fn(), reps=10, clean=True),
                     "call_ms": timer.ms(lambda: fn(), hold=False, reps=10),
                     "tail_max_abs_err": err, "bodies": bodies,
                     **_kernel_ms(lambda: fn(), reps=3)}
        del got, lse, want
    return out


def attention_bwd_turn(src: str) -> dict:
    """One turn of ``--attention-bwd``, in this process."""
    _on_path(src)
    import math

    import chip_smoke as cs
    from _torch_cases import BWD_TOL
    from repro_torch.kernels import build, ref
    from repro_torch.models import get_arch
    build.build_all(("flash_attention_bwd",))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    timer = _Timer()
    out = {"src": src}
    for arch_name, B in TRAIN_KERNEL_SHAPES:
        a = get_arch(arch_name)
        H, KV, T, hd = a.n_heads, a.n_kv_heads, cs.TRAIN_T, a.hd
        q, k, v, do = _bwd_inputs(B, H, KV, T, T, hd, hd, seed=7)
        kw = dict(causal=True, window=a.window, chunk=None,
                  scale=1.0 / math.sqrt(hd))
        o, lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         return_lse=True, **kw)
        o = o.to(q.dtype).transpose(1, 2).contiguous().transpose(1, 2)
        fn = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           o.float(), lse, do.float(), **kw)
        errs = [_rel_peak(g, w) for g, w in zip(fn(), want)]
        cs.check(all(e <= BWD_TOL["bfloat16"] for e in errs),
                 f"{src}: flash_attention_bwd at {arch_name}: {errs}")
        out[arch_name] = {"ms": timer.ms(fn, reps=20),
                          "clean_ms": timer.ms(fn, clean=True, reps=20),
                          "call_ms": timer.ms(fn, hold=False, reps=20),
                          **_kernel_ms(fn), "rel_err": errs}
        del q, k, v, do, o, lse, want
    return out


def scan_bwd_turn(src: str) -> dict:
    """One turn of ``--scan-bwd``, in this process."""
    _on_path(src)
    import chip_smoke as cs
    from _torch_cases import BWD_TOL, scan_bwd_inputs
    from repro_torch.kernels import build, ref
    from repro_torch.models import get_arch
    build.build_all(("rwkv6_scan", "rwkv6_scan_bwd"))
    rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    a = get_arch(cs.TRAIN_RWKV_ARCH)
    H, K, T = a.n_heads, a.d_model // a.n_heads, cs.TRAIN_T
    r, k, v, w, u, _, dy, _ = scan_bwd_inputs(1, H, T, K, K, "bfloat16",
                                              False, None, seed=7,
                                              device="cuda")
    _, _, L, D = rs._forward(r, k, v, w, u, None)
    fn = lambda: rs.rwkv6_scan_bwd(r, k, v, w, u, None, dy, None, L, D)  # noqa: E731
    want = ref.rwkv6_scan_bwd_ref(r.float(), k.float(), v.float(), w, u,
                                  None, dy.float(), None)
    errs = [_rel_peak(g, x) for g, x in zip(fn(), want)][:5]
    tols = (BWD_TOL["bfloat16"],) * 3 + (BWD_TOL["float32"],) * 2
    cs.check(all(e <= t for e, t in zip(errs, tols)),
             f"{src}: rwkv6_scan_bwd at the training call: {errs}")
    timer = _Timer()
    return {"src": src, "rwkv6-3b_train": {
        "ms": timer.ms(fn, reps=20),
        "clean_ms": timer.ms(fn, clean=True, reps=20),
        "call_ms": timer.ms(fn, hold=False, reps=20),
        **_kernel_ms(fn), "rel_err_dr_dk_dv_dw_du": errs}}


def adamw_turn(src: str) -> dict:
    """One turn of ``--adamw``, in this process."""
    _on_path(src)
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.launch.specs import abstract_params, make_optimizer
    from repro_torch.models import get_arch
    from repro_torch.optim import optimizers as optim
    kernels = importlib.import_module("repro_torch.kernels")
    fused = getattr(kernels, "adamw", None)
    cfg = get_arch("h2o-danube-1.8b")
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = optim.tree_leaves(abstract_params(cfg))
    params = [(torch.randn(t.shape, generator=gen, device="cuda") * 0.02)
              .to(t.dtype) for t in shapes]
    grads = [(torch.randn(t.shape, generator=gen, device="cuda") * 1e-4)
             .to(t.dtype) for t in shapes]
    opt = make_optimizer(cfg, total_steps=100)
    eager_opt = dataclasses.replace(opt, fused=None) \
        if hasattr(opt, "fused") else opt
    state = opt.init(params)
    step = 20

    def eager():      # make_train_step's eager clip, update and apply
        gs, _ = optim.clip_by_global_norm(list(grads), 1.0)
        updates, _ = eager_opt.update(gs, state, params, step)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.copy_((p.float() + u.float()).to(p.dtype))

    def fused_step():
        norm, update = opt.fused(grads, state, params, step)
        update(optim.clip_scale(norm(), 1.0))

    timer = _Timer()
    entry = {}
    if fused is not None:
        p1, m1, v1 = ([t.clone() for t in ts] for ts in
                      (params, state["m"], state["v"]))
        norm_of, update = opt.fused(grads, {"m": m1, "v": v1}, p1, step)
        norm, again = norm_of(), norm_of()
        exact = sum(float((g.double() ** 2).sum()) for g in grads) ** 0.5
        scale = optim.clip_scale(norm, 1.0)
        update(scale)
        with torch.no_grad():
            gs = [(g.float() * scale).to(g.dtype) for g in grads]
            updates, _ = eager_opt.update(gs, state, params, step)
            for p, u in zip(params, updates):
                p.copy_((p.float() + u.float()).to(p.dtype))
        del gs, updates
        same = all(torch.equal(a, b) for xs, ys in
                   ((p1, params), (m1, state["m"]), (v1, state["v"]))
                   for a, b in zip(xs, ys))
        del p1, m1, v1
        torch.cuda.empty_cache()
        cs.check(same, f"{src}: the fused pass differs from the eager path")
        cs.check(torch.equal(norm, again), f"{src}: the norm repeats not")
        entry = {"ms": timer.ms(fused_step, reps=10),
                 "clean_ms": timer.ms(fused_step, clean=True, reps=10),
                 "call_ms": timer.ms(fused_step, hold=False, reps=10),
                 **_kernel_ms(fused_step, reps=2),
                 "bit_identical": same,
                 "norm_rel_err": abs(float(norm) - exact) / exact}
    eager_ms = {"ms": timer.ms(eager, reps=10),
                "call_ms": timer.ms(eager, hold=False, reps=10)}
    if fused is None:
        entry = {**eager_ms, "clean_ms": eager_ms["ms"]}
    else:
        entry["eager"] = eager_ms
    entry["params"] = sum(t.numel() for t in params)
    return {"src": src, "h2o-danube-1.8b_optimizer": entry}


def turn(src: str) -> dict:
    """One turn, in this process: the kernels of the checkout at ``src``."""
    _on_path(src)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    build.build_all(("join_probe", "segment_reduce"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    m = cs.N_CUSTOMERS
    keys = torch.as_tensor(rng.integers(0, m, cs.N_ORDERS).astype(np.int32),
                           device=dev)
    build_keys = torch.as_tensor(rng.permutation(m).astype(np.int32), device=dev)
    sorted_keys = torch.arange(m, dtype=torch.int32, device=dev)
    vals = torch.as_tensor(rng.integers(0, 5, cs.N_TASKS).astype(np.float32),
                           device=dev)
    segs = torch.zeros(cs.N_TASKS, dtype=torch.int32, device=dev)
    segs600 = torch.as_tensor(rng.integers(0, 600, cs.N_TASKS).astype(np.int32),
                              device=dev)
    slots = ops.build_direct_table(build_keys, m)
    calls = {
        "join_probe": (lambda: ops.join_probe(keys, slots),
                       lambda: ref.slot_gather_ref(keys, slots)),
        "build_direct_table": (lambda: ops.build_direct_table(build_keys, m),
                               lambda: ref.build_direct_table_ref(build_keys, m)),
        # the main path's build side: surrogate keys in row order
        "build_direct_table_sorted": (
            lambda: ops.build_direct_table(sorted_keys, m),
            lambda: ref.build_direct_table_ref(sorted_keys, m)),
        "segment_reduce": (lambda: ops.segment_reduce(vals, segs, 1),
                           lambda: ref.segment_reduce_ref(vals, segs, 1)),
        "segment_reduce_g600": (lambda: ops.segment_reduce(vals, segs600, 600),
                                lambda: ref.segment_reduce_ref(vals, segs600,
                                                               600)),
    }
    jp = importlib.import_module("repro_torch.kernels.join_probe")
    if hasattr(jp, "probe_cluster"):   # both probe routes at this shape
        calls["join_probe_l2_route"] = (lambda: jp._probe(keys, slots, 0),
                                        calls["join_probe"][1])
    timer = _Timer()
    out = {"src": src}
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, want), f"{src}: {name} differs from plain")
        out[name] = {"ms": timer.ms(fn), "clean_ms": timer.ms(fn, clean=True),
                     "call_ms": timer.ms(fn, hold=False), **_kernel_ms(fn)}
    return out


def main() -> int:
    attention = "--attention" in sys.argv
    attention_bwd = "--attention-bwd" in sys.argv
    scan_bwd = "--scan-bwd" in sys.argv
    adamw = "--adamw" in sys.argv
    archs = [sys.argv[i + 1] for i, a in enumerate(sys.argv)
             if a == "--arch"] or list(ATTENTION_ARCHS)
    if len(sys.argv) >= 3 and sys.argv[1] == "--turn":
        if adamw:
            out = adamw_turn(sys.argv[2])
        elif scan_bwd:
            out = scan_bwd_turn(sys.argv[2])
        elif attention_bwd:
            out = attention_bwd_turn(sys.argv[2])
        elif attention and "--cells" in sys.argv:
            out = attention_cells_turn(sys.argv[2])
        elif attention:
            out = attention_turn(sys.argv[2], archs)
        else:
            out = turn(sys.argv[2])
        print(json.dumps(out), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 1
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_ab.py: CUDA is not available", file=sys.stderr)
        return 2
    if adamw:
        entries, flags = ["h2o-danube-1.8b_optimizer"], ["--adamw"]
    elif scan_bwd:
        entries, flags = ["rwkv6-3b_train"], ["--scan-bwd"]
    elif attention_bwd:
        entries = [arch for arch, _ in TRAIN_KERNEL_SHAPES]
        flags = ["--attention-bwd"]
    elif attention and "--cells" in sys.argv:
        entries, flags = list(CELL_CALLS), ["--attention", "--cells"]
    elif attention:
        entries = [f"{a}_{c}" for a in archs for c in ("prefill", "decode")]
        flags = ["--attention"] + [x for a in archs for x in ("--arch", a)]
    else:
        entries, flags = ENTRIES, []
    ab = {k: {"other": [], "this": []} for k in entries}
    for _ in range(rounds):
        for label, root in (("other", other), ("this", HERE), ("this", HERE),
                            ("other", other)):
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--turn",
                 str(root / "src")] + flags,
                capture_output=True, text=True,
                timeout=900, env={**os.environ, "PYTHONPATH": ""})
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": label, **line}), flush=True)
            for k in entries:
                ab[k][label].append([line[k]["ms"], line[k]["clean_ms"],
                                     line[k]["call_ms"]])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ab": ab}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
