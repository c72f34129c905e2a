#!/usr/bin/env python3
"""Time design variants of the attention's backward kernel beside the
shipped one, on one NVIDIA GPU.

    python3 tools/attention_bwd_variants.py [--rounds R] [--variant NAME ...]
                                            [--ablate]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` once per
variant, each a copy of the source patched by ``variant_source`` under
``build/tools/`` (the flags of ``repro_torch.kernels.build``), one ``nvcc``
each, all started together, and prints each build's registers, spills
and ptxas's notes on serialized wgmma. Then, at the shapes of
``chip_smoke.TRAIN_KERNEL_SHAPES`` (danube: 4 x 2,048, H 32 / KV 8, hd 80,
causal, window 4,096; qwen2-vl: 1 x 2,048, H 64 / KV 8, hd 128; stablelm:
1 x 2,048, H 32 / KV 8, hd 160), seeded bf16 inputs and the forward
kernel's output and log-sum-exps, it holds every variant's wgmma body to
the plain version in fp32 (dq, dk, dv within ``chip_smoke.BWD_TOL`` bf16
roundings of their peak; a second call bit-identical) and times it with
``chip_smoke.py``'s timer (CUDA events, L2 flushed before each launch,
median), with the device time of each kernel it launches
(``torch.profiler``). Prints one JSON line per variant, shape and round,
the card's name and power limit, and exits non-zero if a variant disagrees
with the plain version.

The variants (``VARIANTS``): the shipped source; ``no_ring`` (one slot:
each tile waits for its own loads, the first step's baseline); ``ring_2``
(one tile ahead); ``split_p_ds`` (P and dS as bf16 hi + lo, two products
each); ``one_warpgroup`` (64 rows a block).

``--ablate`` times, instead, the shipped source with parts of each step
cut out (``ABLATIONS``: no exponentials, no tile products, no loads past
the ring's first fill, and pairs of these). Their results are wrong by
design and are not checked; what a cut saves says how much of the step
that part holds up.
"""

import ctypes
import importlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention_bwd.cu"
VARIANTS = ("shipped", "no_ring", "ring_2", "split_p_ds", "one_warpgroup")
ABLATIONS = {"shipped": (), "no_exp": ("ABLATE_EXP",),
             "no_mma": ("ABLATE_MMA",), "no_load": ("ABLATE_LOAD",),
             "no_exp_no_load": ("ABLATE_EXP", "ABLATE_LOAD"),
             "no_mma_no_load": ("ABLATE_MMA", "ABLATE_LOAD")}


def ablatable(src: str) -> str:
    """The source with ABLATE_* cuts at the top of the exponentials
    (``probs_tile``), the tile products (``wg_rows_by_rows``,
    ``wg_frags_by_rows``) and the ring's loads past its first fill."""
    cuts = [
        (r"(void probs_tile\([^{]*\{\n)", "ABLATE_EXP", "return;"),
        (r"(void wg_rows_by_rows\([^{]*\{\n)", "ABLATE_MMA", "return;"),
        (r"(void wg_frags_by_rows\([^{]*\{\n)", "ABLATE_MMA", "return;"),
        (r"(  auto load = \[&\]\(int step\) \{\n)", "ABLATE_LOAD",
         "if (step >= kAhead) return;"),
    ]
    for pattern, macro, body in cuts:
        src, n = re.subn(pattern, rf"\1#ifdef {macro}\n  {body}\n#endif\n", src)
        if n == 0:
            raise RuntimeError(f"ablation anchor {pattern!r} not in the source")
    return src


def _replace(src: str, old: str, new: str, count: int) -> str:
    """``src`` with each of the ``count`` copies of ``old`` replaced."""
    if src.count(old) != count:
        raise RuntimeError(f"variant anchor {old!r} found {src.count(old)} "
                           f"times, not {count}")
    return src.replace(old, new)


# P and dS as bf16 hi + lo: the low halves' fragments, x - bf16(x) rounded
TO_FRAGS_LO = """
template <int NB>
__device__ __forceinline__ void to_frags_lo(uint32_t (&f)[NB / 2][4], const float (&x)[NB][4]) {
  auto lo = [](float x0, float x1) {
    const float2 h = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
    return bits(__floats2bfloat162_rn(x0 - h.x, x1 - h.y));
  };
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    f[kk][0] = lo(x[2 * kk][0], x[2 * kk][1]);
    f[kk][1] = lo(x[2 * kk][2], x[2 * kk][3]);
    f[kk][2] = lo(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    f[kk][3] = lo(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}
"""


def variant_source(src: str, name: str) -> str:
    """The source of one of ``VARIANTS``: the shipped one patched."""
    if name == "shipped":
        return src
    if name == "ring_2":
        return _replace(src, "constexpr int kStages = 3;",
                        "constexpr int kStages = 2;", 1)
    if name == "one_warpgroup":
        return _replace(src, "constexpr int kNwg = 2;",
                        "constexpr int kNwg = 1;", 1)
    if name == "no_ring":
        # one slot: each step loads its own tile and waits for it, and the
        # slot is refilled only after every warp is done with it
        src = _replace(src, "constexpr int kStages = 3;",
                       "constexpr int kStages = 1;", 1)
        src = re.sub(r"cp_async_wait<kAhead - 1>\(\);[^\n]*\n",
                     "load(step);\n    cp_async_commit();\n"
                     "    cp_async_wait<0>();\n", src)
        src = _replace(src, "    if (step + kAhead < steps) load(step + kAhead);\n"
                       "    cp_async_commit();\n", "", 2)
        return _replace(src, "    finish(step);\n  }\n",
                        "    finish(step);\n    __syncthreads();\n  }\n", 2)
    if name == "split_p_ds":
        # a second product with each fragment's low half, held as the high
        # half is until the products are waited for
        src = _replace(src, "uint32_t pf[BQ / 16][4], sf[BQ / 16][4];",
                       "uint32_t pf[BQ / 16][4], sf[BQ / 16][4], "
                       "pf_lo[BQ / 16][4], sf_lo[BQ / 16][4];", 1)
        src = _replace(src, "uint32_t sf[kTile / 16][4];",
                       "uint32_t sf[kTile / 16][4], sf_lo[kTile / 16][4];", 1)
        src, n = re.subn(r"(void to_frags\(.*?\n}\n)",
                         lambda m: m.group(1) + TO_FRAGS_LO, src, count=1,
                         flags=re.S)
        if n != 1:
            raise RuntimeError("variant anchor to_frags not in the source")
        src = re.sub(r"hold\((pf|sf)\);\n(\s*)", r"hold(\1);\n\2hold(\1_lo);\n\2",
                     src)
        src, n = re.subn(
            r"to_frags<([^>]+)>\((\w+), (\w+)\);\n"
            r"(.*?wgmma_fence\(\);\n\s*)"
            r"(wg_frags_by_rows<[^>]+>)\((\w+), \2, (\w+)\);([^\n]*)\n",
            r"to_frags<\1>(\2, \3);\n    to_frags_lo<\1>(\2_lo, \3);\n\4"
            r"\5(\6, \2, \7);\8\n    \5(\6, \2_lo, \7);\n", src, flags=re.S)
        if n != 3:
            raise RuntimeError(f"split anchors: {n} products, not 3")
        return src
    raise ValueError(f"unknown variant {name!r}")


def build_variants(jobs, nvcc, flags):
    """One library per (name, source text, defines) job, the source written
    under build/tools, all nvcc started together."""
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text, defs in jobs:
        src = out_dir / f"flash_attention_bwd_{name}.cu"
        src.write_text(text)
        so = out_dir / f"libflash_attention_bwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, *[f"-D{d}" for d in defs], "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = so
        print(json.dumps({"variant": name, "ptxas": ptxas_summary(log)}),
              flush=True)
    return libs


def ptxas_summary(log: str) -> dict:
    """Registers and spills of each wgmma-body kernel, from ``-Xptxas -v``,
    and ptxas's performance notes (wgmma serialized, and why)."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = next((k for k in ("flash_bwd_wg", "delta_vec")
                           if k in name), None)
            if kernel:
                dims = re.findall(r"Li(\d+)E", name[name.index(kernel):])
                kernel += "<" + ", ".join(dims) + ">"
        elif kernel and ("registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
        elif "Performance Loss" in line and "due to" in line:
            reason = line.split("due to", 1)[1].split(" in the function")[0]
            out.setdefault("serialized", []).append(reason.strip())
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_variants.py: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.models import get_arch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 1
    ablate = "--ablate" in sys.argv
    source = SOURCE.read_text()
    if ablate:
        text = ablatable(source)
        jobs = [(f"ablate_{n}", text, list(cuts))
                for n, cuts in ABLATIONS.items()]
    else:
        names = [sys.argv[i + 1] for i, a in enumerate(sys.argv)
                 if a == "--variant"] or list(VARIANTS)
        jobs = [(n, variant_source(source, n), []) for n in names]
    libs = {}
    for name, so in build_variants(jobs, build._nvcc(),
                                   build.NVCC_FLAGS).items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in fa._BWD_SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[name] = lib

    timer = cs._Timer()
    failed = []
    for r in range(rounds):
        for arch_name, B, _ in cs.TRAIN_KERNEL_SHAPES:
            a = get_arch(arch_name)
            H, KV, T, hd = a.n_heads, a.n_kv_heads, cs.TRAIN_T, a.hd
            q, k, v, do = cs._bwd_inputs(B, H, KV, T, T, hd, hd, seed=7)
            scale = 1.0 / math.sqrt(hd)
            kw = dict(causal=True, window=a.window, chunk=None, scale=scale)
            o, lse = fa._forward(q, k, v, True, a.window, None, scale,
                                 with_lse=True)
            want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                               o.float(), lse, do.float(), **kw)
            for name, lib in libs.items():
                fn = lambda lib=lib: fa.launch_bwd(  # noqa: E731
                    lib, q, k, v, o, lse, do, True, a.window, None, scale,
                    "wgmma", hd)
                got, again = fn(), fn()
                cs.sync()
                errs = [cs._rel_peak(g, w) for g, w in zip(got, want)]
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                ok = same and all(e <= cs.BWD_TOL * 2.0 ** -8 for e in errs)
                if not ok and not ablate:
                    failed.append((name, arch_name))
                del got, again
                print(json.dumps({
                    "round": r, "variant": name,
                    "shape": arch_name, "ms": timer.ms(fn, reps=20),
                    **cs._kernel_ms(fn), "rel_err_dq_dk_dv": errs,
                    "bit_identical_second_call": same}), flush=True)
            del q, k, v, do, o, lse, want
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    if failed:
        print(f"variants off the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
