"""Multi-pod dry-run: run every (arch × shape) step on the production meshes
on meta tensors, and count its flops, bytes, collectives and memory.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell with XLA on 256 or 512 forced host devices. torch has no
compiler pass to ask, so the port RUNS the step: on the CPU, on meta
tensors (shapes and types, no storage), as DTensors placed by the
sharding policy on a mesh of a fake process group of 256 or 512 ranks in
this one process (``mesh.fake_group``; its collectives move nothing).
``run_cell`` starts and stops that group itself; importing this module
changes no environment and no process state.

Where each field of a cell's record comes from:

  flops_per_device   FlopCounterMode's formulas (``flop_registry``) over
                     the local ops of this rank (rank 0): DTensor turns each
                     op into local ops on the rank's shards, and only those
                     are counted. (FlopCounterMode around DTensor code
                     counts the GLOBAL program.) A meta tensor holds no
                     data for a kernel: on each rank's shards the
                     attention and the RWKV6 scan run (and count) their
                     plain versions (``_plain_kernels``).
  bytes_per_device   each local non-view op's tensor inputs read once and
                     outputs written once: unfused traffic (XLA's "bytes
                     accessed" is after fusion, so it reads lower). An
                     allocation (``empty``) writes nothing and is left out.
  collectives        ``counts`` from ``CommDebugMode`` under XLA's HLO names;
                     ``bytes_per_device`` and ``by_type`` sum the result
                     bytes of each functional collective on this rank (the
                     reference sums HLO result shapes). On a CPU group
                     DTensor's all-to-all is an all-gather plus a chunk.
  memory             the local shard bytes of the arguments and outputs,
                     the outputs that are the arguments updated in place
                     (``alias``), and the bytes saved for the backward
                     (``saved_activation_bytes``, local shards; under remat
                     only each layer's inputs). XLA's ``temp_size_in_bytes``
                     and ``generated_code_size_in_bytes`` have no
                     counterpart: null.
  lower_s/compile_s  null: nothing is lowered or compiled (``run_s`` is the
                     eager run's wall time on the CPU).

Two passes per cell, as the reference's:

  A   the FULL config with the production policy (remat, microbatching).
      The port's layer loops are always unrolled (``unroll_layers`` is
      moot), so A's counts are exact at full depth.
  B   the same cell at two reduced depths (k1 < k2), microbatch 1:
      per-layer cost = (f(k2) − f(k1)) / (k2 − k1), extrapolated linearly
      to the full depth (the reference's accounting, kept so the two
      packages' records compare; A checks it).

Usage:
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out reports/dryrun]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..analysis.roofline import roofline_terms
from ..configs import ALL_ARCHS, SHAPES
from ..kernels import ops, ref
from ..models.arch import get_arch
from ..optim.optimizers import tree_leaves
from .mesh import fake_group, make_production_mesh, mesh_info
from .sharding import make_policy
from .specs import input_specs, make_optimizer, shape_kind, step_fn

__all__ = ["run_cell", "runnable", "accounting_depths", "reduced", "main"]

# functional collectives, by XLA's HLO name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that allocate and write nothing (DTensor makes such buffers on its
# first run of an op): no traffic
_ALLOCATIONS = frozenset({torch.ops.aten.empty, torch.ops.aten.empty_strided,
                          torch.ops.aten.empty_like, torch.ops.aten.new_empty,
                          torch.ops.aten.new_empty_strided})

_NOTES = {
    "flops": "FlopCounterMode's formulas over rank 0's local ops on meta "
             "tensors (the attention and the RWKV6 scan count their plain "
             "versions)",
    "bytes": "unfused: every local non-view op's inputs read once and "
             "outputs written once (allocations, which write nothing, "
             "left out)",
    "lower_s": "null: the port runs the step eagerly, nothing is lowered "
               "or compiled (run_s: the eager run on the CPU)",
    "memory": "local shard bytes of arguments and outputs, outputs updated "
              "in place (alias), and tensors saved for the backward "
              "(saved_activation_bytes, the plain attention's under no "
              "remat); XLA's temp and generated-code sizes have no "
              "counterpart (null)",
    "collectives": "counts from CommDebugMode; bytes are the result bytes of "
                   "each functional collective on rank 0; a CPU group's "
                   "all-to-all is an all-gather",
}


def runnable(arch: str, shape: str) -> bool:
    cfg = get_arch(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False  # documented skip: pure full attention at 512k decode
    return True


def accounting_depths(cfg) -> Tuple[int, int, float]:
    """(k1, k2, effective_layer_count) for linear extrapolation."""
    if cfg.ssm_kind == "mamba2" and cfg.shared_attn:
        every = max(1, cfg.hybrid_every)
        return every, 2 * every, float(cfg.n_layers)
    if cfg.moe and cfg.n_dense_layers:
        return cfg.n_dense_layers + 2, cfg.n_dense_layers + 4, float(cfg.n_layers)
    return 2, 4, float(cfg.n_layers)


def reduced(cfg, k: int):
    upd = dict(n_layers=k)
    if cfg.enc_dec:
        upd.update(n_enc_layers=k, n_dec_layers=k)
    return dataclasses.replace(cfg, **upd)


def _nbytes(t) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _LocalCounter(TorchDispatchMode):
    """Counts one rank's local work. An op on DTensors is declined
    (``NotImplemented``): DTensor then runs it as local ops and
    collectives, which come back here. Ops on fake tensors are DTensor's
    sharding propagation (global shapes), not work."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in flat):
            return out
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        name = _COLLECTIVES.get(func.overloadpacket.__name__)
        if name is not None:
            b = sum(_nbytes(o) for o in outs)
            self.coll_bytes[name] = self.coll_bytes.get(name, 0.0) + b
            self.coll_counts[name] = self.coll_counts.get(name, 0) + 1
            return out
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if not func.is_view and func.namespace == "aten" \
                and func.overloadpacket not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in flat + outs)
        return out


@contextlib.contextmanager
def _plain_kernels():
    """The plain versions in the kernels' place where ``ops`` runs them on
    a rank's shards: the wrappers refuse meta tensors (no data to launch
    on), so the shape-only step counts the plain attention and scan."""
    kernels = ops.flash_attention, ops.rwkv6_scan
    ops.flash_attention, ops.rwkv6_scan = (ref.flash_attention_ref,
                                           ref.rwkv6_scan_ref)
    try:
        yield
    finally:
        ops.flash_attention, ops.rwkv6_scan = kernels


def _comm_counts(comm: CommDebugMode) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        name = _COLLECTIVES.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if name is not None:
            out[name] = out.get(name, 0) + n
    return out


def _measure(cfg, shape: str, kind: str, policy) -> dict:
    """Runs the cell's step once on meta DTensors and counts it."""
    optimizer = make_optimizer(cfg) if kind == "train" else None
    fn = step_fn(cfg, kind, policy, optimizer)
    args = input_specs(cfg, shape, policy, optimizer)
    arg_leaves = [t for v in args.values() for t in tree_leaves(v)
                  if isinstance(t, torch.Tensor)]
    saved = [0]

    def pack(t):
        saved[0] += _nbytes(t)
        return t
    counter, comm = _LocalCounter(), CommDebugMode()
    t0 = time.time()
    with _plain_kernels(), comm, counter, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args.values())
    run_s = time.time() - t0
    arg_ids = {id(t) for t in arg_leaves}
    out_leaves = [t for t in tree_leaves(list(out) if isinstance(out, tuple)
                                         else out)
                  if isinstance(t, torch.Tensor)]
    arg_b = sum(_nbytes(t) for t in arg_leaves)
    out_b = sum(_nbytes(t) for t in out_leaves)
    alias_b = sum(_nbytes(t) for t in out_leaves if id(t) in arg_ids)
    counts = _comm_counts(comm)
    if counts != counter.coll_counts:
        raise RuntimeError(f"collective counts disagree: CommDebugMode "
                           f"{counts}, local {counter.coll_counts}")
    return {
        "run_s": round(run_s, 2),
        "flops": float(counter.flops), "bytes": float(counter.bytes),
        "collectives": {"bytes_per_device":
                        float(sum(counter.coll_bytes.values())),
                        "by_type": dict(counter.coll_bytes),
                        "counts": counts},
        "memory": {
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b,
            "alias_size_in_bytes": alias_b,
            "saved_activation_bytes": saved[0],
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "total_hbm_bytes": arg_b + out_b - alias_b + saved[0],
        },
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             strategy: str = "fsdp_tp", remat: Optional[str] = None,
             microbatch: Optional[int] = None, verbose: bool = True,
             accounting: bool = True, policy_overrides: Optional[dict] = None
             ) -> dict:
    cfg = get_arch(arch)
    kind = shape_kind(shape)
    spec = SHAPES[shape]
    overrides = policy_overrides or {}
    remat_eff = remat if remat is not None else \
        ("full" if kind == "train" else "none")
    micro_eff = microbatch if microbatch is not None else \
        (8 if kind == "train" else 1)

    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh_info(mesh)["n_devices"]
        # ---- pass A: full config, production policy
        polA = make_policy(mesh, strategy=strategy, remat=remat_eff,
                           seq_shard=(shape == "long_500k"),
                           microbatch=micro_eff, unroll_layers=False)
        for k, v in overrides.items():
            setattr(polA, k, v)
        passA = _measure(cfg, shape, kind, polA)

        result = {
            "arch": arch, "shape": shape, "kind": kind,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": n_dev, "status": "ok",
            "tokens": spec["seq_len"] * spec["global_batch"],
            "policy": polA.describe(),
            "full_compile": {"lower_s": None, "compile_s": None,
                             "run_s": passA["run_s"],
                             "memory": passA["memory"]},
            "full_collective_counts": passA["collectives"]["counts"],
            "full_flops_per_device": passA["flops"],
            "note": dict(_NOTES),
        }

        # ---- pass B: two-point accounting
        if accounting:
            k1, k2, L_eff = accounting_depths(cfg)
            polB = make_policy(mesh, strategy=strategy, remat=remat_eff,
                               seq_shard=(shape == "long_500k"),
                               microbatch=1, unroll_layers=True)
            for k, v in overrides.items():
                if k != "microbatch":
                    setattr(polB, k, v)
            f1 = _measure(reduced(cfg, k1), shape, kind, polB)
            f2 = _measure(reduced(cfg, k2), shape, kind, polB)

            def extrap(a, b):
                per_layer = (b - a) / (k2 - k1)
                return a + (L_eff - k1) * per_layer

            result.update({
                "accounting": {
                    "k1": k1, "k2": k2,
                    "flops_k1": f1["flops"], "flops_k2": f2["flops"],
                    "compile_s": None,
                    "run_s": f1["run_s"] + f2["run_s"],
                },
                # pass B ran microbatch=1; flops/bytes are per full batch
                "flops_per_device": extrap(f1["flops"], f2["flops"]),
                "bytes_per_device": extrap(f1["bytes"], f2["bytes"]),
                "collectives": {
                    "bytes_per_device": extrap(
                        f1["collectives"]["bytes_per_device"],
                        f2["collectives"]["bytes_per_device"]),
                    "by_type": f2["collectives"]["by_type"],
                    "counts": f2["collectives"]["counts"]},
            })
            result["roofline"] = roofline_terms(cfg, spec, result)

    if verbose:
        slim = {k: v for k, v in result.items() if k != "collectives"}
        print(json.dumps(slim, indent=1, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-accounting", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[cached] {tag}", flush=True)
                    continue
                if not runnable(arch, shape):
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "skipped",
                           "reason": "pure full attention at 512k decode "
                                     "(DESIGN.md §Arch-applicability)"}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[skipped] {tag}", flush=True)
                    continue
                print(f"[run] {tag}", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, verbose=False,
                                   accounting=not args.no_accounting)
                except Exception as e:   # one cell's failure is its record
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "status": "error",
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": repr(e)}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("status") == "ok":
                    rf = rec.get("roofline", {})
                    print(f"  ok in {time.time()-t0:.0f}s dominant="
                          f"{rf.get('dominant')} frac="
                          f"{rf.get('roofline_fraction', 0):.3f}", flush=True)
                else:
                    print(f"  -> {rec.get('status')}: "
                          f"{rec.get('error', '')[:200]}", flush=True)


if __name__ == "__main__":
    main()
