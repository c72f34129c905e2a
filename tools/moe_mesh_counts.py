#!/usr/bin/env python3
"""One MoE layer's per-rank work and traffic under a mesh, on the CPU.

    PYTHONPATH=src python tools/moe_mesh_counts.py [--out counts.json]

Runs ``models.layers.moe`` (forward, then forward + backward) once on meta
DTensors on a fake process group of 8 ranks (``launch.mesh.fake_group``)
under the dry-run's counter (``launch.dryrun._LocalCounter``), for the
dry-run test's MoE cell: llama4-scout ``scaled(d_model=64, n_heads=4,
d_ff=128, vocab=512)`` (8 experts, top 1, a shared expert), 8 x 128
tokens, bf16, meshes (1, 8), (2, 4) and (4, 2) under ``fsdp_tp`` (the
dry-run test's policy) and ``fsdp_tp_ep``. For each it prints the rank's
router product (its rows), its flops, and its collectives' result bytes by
type, with ``n·d + E·cap·d`` (the elements that gathering the tokens and
the expert outputs to every rank moves) beside them. These are counts from
shapes on the CPU, not device measurements. Imports nothing of JAX.
"""

import argparse
import json
import sys

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.sharding import (_divisible, distribute_tree,
                                         make_policy, param_specs, placements)
from repro_torch.models import get_arch, layers

B, T = 8, 128


class _Counter(dryrun._LocalCounter):
    """The dry-run's counter, also keeping the router product's rows: the
    local mm whose second operand is the (d, E) router."""

    def __init__(self, d, E):
        super().__init__()
        self.d, self.E, self.router_rows = d, E, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.overloadpacket is torch.ops.aten.mm and out is not \
                NotImplemented and tuple(args[1].shape) == (self.d, self.E):
            self.router_rows.append(int(args[0].shape[0]))
        return out


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def count(cfg, shape, strategy, backward):
    mesh = make_mesh(shape, ("data", "model"))
    pol = make_policy(mesh, strategy)
    tree = {"layers": [{"moe": _meta(layers.init_moe(torch.Generator(),
                                                       cfg))}]}
    params = distribute_tree(mesh, param_specs(tree, cfg, mesh, strategy),
                             tree)["layers"][0]["moe"]
    x = torch.empty((B, T, cfg.d_model), dtype=torch.bfloat16, device="meta")
    x = distribute_tensor(x, mesh, placements(
        _divisible(x.shape, pol.rules["act_btd"], mesh), mesh))
    if backward:
        x.requires_grad_(True)
    c = _Counter(cfg.d_model, cfg.n_experts)
    with dryrun._plain_kernels(), c:
        y, aux = layers.moe(params, x, cfg, pol)
        if backward:
            (y.sum() + aux).backward()
    n, d, E = B * T, cfg.d_model, cfg.n_experts
    cap = int(max(8, -(-n * cfg.top_k * cfg.capacity_factor // E)))
    return {"mesh": list(shape), "strategy": strategy,
            "backward": backward, "router_rows": c.router_rows,
            "router_flops_forward": 2 * c.router_rows[0] * d * E,
            "flops": c.flops, "collective_bytes": c.coll_bytes,
            "collective_counts": c.coll_counts,
            "gathered_elements": n * d + E * cap * d, "cap": cap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = get_arch("llama4-scout-17b-a16e").scaled(
        d_model=64, n_heads=4, d_ff=128, vocab=512)
    rows = []
    with fake_group(8):
        for shape in ((1, 8), (2, 4), (4, 2)):
            for strategy in ("fsdp_tp", "fsdp_tp_ep"):
                for backward in (False, True):
                    rows.append(count(cfg, shape, strategy, backward))
                    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
