#!/usr/bin/env python3
"""Time the RWKV6 scan's backward kernel's two bodies, and with
``--ablate`` copies of it with parts of the CUDA-core body's row pass cut
out, on one NVIDIA GPU.

    python3 tools/scan_bwd_variants.py [--rounds R] [--ablate]

Builds ``src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu`` as it is, or with
``--ablate`` once per entry of ``ABLATIONS`` (a copy of the source with
``ABLATE_*`` switches patched in by ``ablatable``, under ``build/tools/``:
no reduce-scatter, no staging loads, no shared memory history, and all
three), with the flags of ``repro_torch.kernels.build``, one ``nvcc`` each,
all started together, and prints each build's registers and spills.
Then, at rwkv6-3b's training call (B 1 and B 2 rows of 2,048 tokens, H 40,
K = V = 64, bf16 r/k/v/dy; seeded inputs and the forward kernel's chunk
states), it launches each build on both bodies, the tensor-core "mma"
body the training call takes and the CUDA-core "simt" body
(``rwkv6_scan.launch_bwd`` with the body named; with ``--ablate`` the simt
body alone, whose row pass the cuts are in), holds the shipped source to
the plain version in fp32 (dr, dk, dv within ``chip_smoke.BWD_TOL`` bf16
roundings of their peak, dw and du within ``chip_smoke.BWD_TOL_FP32``; a
second call bit-identical) and times each with ``chip_smoke.py``'s timer
(CUDA events, L2 flushed before each launch, median), with the device
time of each of its kernels (``torch.profiler``). The cut copies' results
are wrong by design and are not checked; what a cut saves says how much
of the pass that part holds up. Prints one JSON line per build, body,
shape and round, the card's name and power limit, and exits non-zero if
the shipped source disagrees with the plain version.
"""

import ctypes
import importlib
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rwkv6_scan_bwd.cu"
ABLATIONS = {"shipped": (), "no_scatter": ("ABLATE_SCATTER",),
             "no_stage": ("ABLATE_STAGE",), "no_hist": ("ABLATE_HIST",),
             "none_of_them": ("ABLATE_SCATTER", "ABLATE_STAGE",
                              "ABLATE_HIST")}
BATCHES = (1, 2)

# the row pass's staging loads of v and dy
STAGE_LOADS = """        x[q] = to_f32(v[at(a.sv, b, h, tb + t, j)]);
        g[q] = to_f32(dy[at(a.sdy, b, h, tb + t, j)]);"""
HIST_STORE = "        if (keep) hist_s[j * nthreads + tid] = S;\n"
HIST_LOAD = "        const float2 hs = hist_s[j * nthreads + tid];\n"


def _replace(src: str, old: str, new: str, count: int) -> str:
    """``src`` with each of the ``count`` copies of ``old`` replaced."""
    if src.count(old) != count:
        raise RuntimeError(f"ablation anchor {old!r} found {src.count(old)} "
                           f"times, not {count}")
    return src.replace(old, new)


def ablatable(src: str) -> str:
    """The source with ABLATE_* cuts: the reduce-scatter's shuffles
    (``reduce_scatter`` returns a lane's own first sum), the staging's
    device loads (zeros in their place) and the history in shared memory
    (the backward pairs G with the forward's last state instead)."""
    src, n = re.subn(r"(float reduce_scatter\([^{]*\{\n)",
                     r"\1#ifdef ABLATE_SCATTER\n  return x[0];\n#endif\n", src)
    if n != 1:
        raise RuntimeError("ablation anchor reduce_scatter not in the source")
    src = _replace(src, STAGE_LOADS,
                   "#ifdef ABLATE_STAGE\n        x[q] = 0.f * t;\n"
                   "        g[q] = 0.f * j;\n#else\n" + STAGE_LOADS +
                   "\n#endif", 1)
    src = _replace(src, HIST_STORE,
                   "#ifndef ABLATE_HIST\n" + HIST_STORE + "#endif\n", 1)
    return _replace(src, HIST_LOAD,
                    "#ifdef ABLATE_HIST\n        const float2 hs = S;\n#else\n"
                    + HIST_LOAD + "#endif\n", 1)


def build_variants(jobs, nvcc, flags):
    """One library per (name, source text, defines) job, the source written
    under build/tools, all nvcc started together."""
    import chip_smoke as cs
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text, defs in jobs:
        src = out_dir / f"rwkv6_scan_bwd_{name}.cu"
        src.write_text(text)
        so = out_dir / f"librwkv6_scan_bwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, *[f"-D{d}" for d in defs], "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = so
        ptxas = {k: v for k, v in cs._ptxas_by_kernel(log).items()
                 if "__nv_bfloat16, 64" in k or k.endswith("<64>")}
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_variants.py: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.models import get_arch
    rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 1
    ablate = "--ablate" in sys.argv
    source = SOURCE.read_text()
    if ablate:
        text = ablatable(source)
        jobs = [(f"ablate_{n}", text, list(cuts))
                for n, cuts in ABLATIONS.items()]
    else:
        jobs = [("shipped", source, [])]
    build.build_all(("rwkv6_scan",))
    libs = {}
    for name, so in build_variants(jobs, build._nvcc(),
                                   build.NVCC_FLAGS).items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in rs._BWD_SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[name] = lib

    a = get_arch(cs.TRAIN_RWKV_ARCH)
    H, K = a.n_heads, a.d_model // a.n_heads
    timer = cs._Timer()
    failed = []
    tols = (cs.BWD_TOL * 2.0 ** -8,) * 3 + (cs.BWD_TOL_FP32,) * 3
    bodies = ("simt",) if ablate else tuple(rs.BWD_BODIES)
    for r in range(rounds):
        for B in BATCHES:
            r_, k_, v_, w_, u_, _, dy, _ = cs._scan_inputs(
                B, H, cs.TRAIN_T, K, K, "bfloat16", False, None, seed=7)
            _, _, L, D = rs._forward(r_, k_, v_, w_, u_, None)
            want = ref.rwkv6_scan_bwd_ref(r_.float(), k_.float(),
                                          v_.float(), w_, u_, None,
                                          dy.float(), None)
            for (name, lib), body in itertools.product(libs.items(),
                                                       bodies):
                fn = lambda lib=lib, body=body: rs.launch_bwd(  # noqa: E731
                    lib, r_, k_, v_, w_, u_, None, dy, None, L, D, body)
                got, again = fn(), fn()
                cs.sync()
                errs = [cs._rel_peak(g, w) for g, w in zip(got, want)]
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                ok = same and all(e <= t for e, t in zip(errs[:5], tols))
                if not ok and name in ("shipped", "ablate_shipped"):
                    failed.append((name, body, B))
                del got, again
                print(json.dumps({
                    "round": r, "variant": name, "body": body, "B": B,
                    "ms": timer.ms(fn, reps=20),
                    **cs._kernel_ms(fn, expect=cs.SCAN_BWD_KERNELS[body]),
                    "rel_err_dr_dk_dv_dw_du": errs[:5],
                    "bit_identical_second_call": same}), flush=True)
            del r_, k_, v_, w_, u_, dy, L, D, want
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
