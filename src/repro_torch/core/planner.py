"""Cobra as a distributed-execution planner (the beyond-paper integration).

The port of ``repro.core.planner``, pure Python, copied with its imports
retargeted; names are kept (``TPUCostModel`` included) so a reader finds
the counterpart. The device rates come from the ``HW`` table it is given
(``repro_torch.analysis.roofline.HW``, the H100 SXM's by default; the
reference's table pinned through ``ExecutionContext.hw`` reproduces the
reference's plans).

The paper's insight — enumerate equivalent program implementations in an
AND-OR DAG over regions and choose by a cost model — applied to the
train/serve step program on a device mesh. The SAME ``Memo``/``Rule``/search
machinery from ``core.dag`` is reused; what changes is the domain:

  region          → step-program region (embed / layer stack / head / update)
  transformation  → layout rule (DP/FSDP/TP), remat rule (T2/N2 analogue:
                    recompute vs. store), microbatch rule, weight-prefetch
                    rule (N1 analogue: gather-once-and-cache = replicated
                    weights vs. per-layer re-gather = FSDP), MoE dispatch
                    rule (T4 analogue: batch per-token expert lookups into
                    one all_to_all vs. replicate-and-select)
  cost model      → three-term roofline (compute / HBM / interconnect)
                    with an HBM feasibility constraint (the ``HW`` table's
                    ``hbm_bytes``)

``plan()`` returns the least-cost ``PlanChoice`` with predicted terms; the
launcher materializes it as a ``MeshPolicy``. ``benchmarks/bench_planner``
validates predictions against the compiled dry-run numbers.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

from ..analysis.roofline import HW
from ..models.arch import ArchConfig
from .dag import AndNode, Memo

__all__ = ["PlanChoice", "TPUCostModel", "plan", "enumerate_plans"]


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    strategy: str          # dp | fsdp | tp | fsdp_tp
    remat: str             # none | dots | full
    microbatch: int
    seq_shard: bool
    moe_mode: str          # none | ep_all_to_all | replicated

    def key(self):
        return dataclasses.astuple(self)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    pod: int
    data: int
    model: int

    @property
    def n(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


class TPUCostModel:
    """Analytic three-term roofline for one step of (cfg × shape × plan).

    The napkin math the hypothesis→measure loop (EXPERIMENTS.md §Perf)
    starts from; deliberately simple and fully inspectable."""

    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int,
                 kind: str, mesh: MeshShape):
        self.cfg = cfg
        self.T = seq_len
        self.B = global_batch
        self.kind = kind
        self.mesh = mesh

    # ------------------------------------------------------------ components
    def _param_bytes(self) -> float:
        return self.cfg.n_params() * 2.0  # bf16

    def _expert_bytes(self) -> float:
        c = self.cfg
        if not c.moe:
            return 0.0
        mff = c.moe_d_ff or c.d_ff
        return 3.0 * c.d_model * mff * c.n_experts * 2.0 * \
            (c.n_layers - c.n_dense_layers)

    def _opt_bytes(self) -> float:
        if self.kind != "train":
            return 0.0
        per = 8.0 if self.cfg.n_params() <= 5e11 else 0.5  # adamw vs adafactor
        return self.cfg.n_params() * per

    def _tokens(self) -> float:
        if self.kind == "decode":
            return float(self.B)
        return float(self.B * self.T)

    def _flops_total(self, plan: PlanChoice) -> float:
        c = self.cfg
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[self.kind]
        f = mult * c.n_active_params() * self._tokens()
        # attention context term
        if c.attn_kind != "none":
            eff_ctx = self.T
            if c.window:
                eff_ctx = min(self.T, c.window)
            if c.chunk_size:
                eff_ctx = min(eff_ctx, c.chunk_size)
            if self.kind == "decode":
                per_tok_ctx = eff_ctx
            else:
                per_tok_ctx = eff_ctx / 2.0
            n_attn = c.n_layers if not c.shared_attn else \
                max(1, c.n_layers // max(1, c.hybrid_every))
            f += (2.0 if self.kind != "train" else 6.0) * 2.0 * \
                self._tokens() * per_tok_ctx * c.n_heads * c.hd * n_attn
        if plan.remat == "full" and self.kind == "train":
            f *= 4.0 / 3.0   # one extra forward
        elif plan.remat == "dots" and self.kind == "train":
            f *= 7.0 / 6.0
        return f

    def _act_bytes_per_device(self, plan: PlanChoice) -> float:
        c = self.cfg
        tok_dev = self._tokens() / (self.mesh.dp if not plan.seq_shard
                                    else self.mesh.n / self.mesh.model)
        per_layer = tok_dev * c.d_model * 2.0 * 4.0   # a few live tensors
        if self.kind != "train":
            # inference: no backward, nothing saved; prefill can chunk the
            # batch (chunked prefill) — microbatch models that
            return per_layer * 2.0 / max(1, plan.microbatch)
        live_layers = 2 if plan.remat == "full" else c.n_layers
        mb = max(1, plan.microbatch)
        # both live activations AND remat-saved layer carries are per
        # microbatch (each microbatch's backward completes before the next)
        return (per_layer * live_layers
                + tok_dev * c.d_model * 2.0 * c.n_layers * 0.25) / mb

    # -------------------------------------------------------------- terms
    def terms(self, plan: PlanChoice) -> Dict[str, float]:
        m = self.mesh
        c = self.cfg
        n = m.n
        P = self._param_bytes()
        tok = self._tokens()
        tok_dev = tok / m.dp

        # ---- compute
        t_compute = self._flops_total(plan) / (n * HW["peak_flops"])

        # ---- memory residency (feasibility) + traffic
        if plan.strategy in ("fsdp", "fsdp_tp", "fsdp_tp_ep"):
            resident = (P + self._opt_bytes()) / n
        elif plan.strategy == "tp":
            resident = (P + self._opt_bytes()) / m.model
        else:  # dp: replicated weights ("prefetched once")
            resident = P + self._opt_bytes()
        if plan.moe_mode == "replicated" and c.moe:
            mff = c.moe_d_ff or c.d_ff
            expert_bytes = 3 * c.d_model * mff * c.n_experts * 2.0 * \
                (c.n_layers - c.n_dense_layers)
            resident += expert_bytes * (1.0 - 1.0 / m.model)
        resident += self._act_bytes_per_device(plan)
        if self.kind == "decode":
            resident += self._kv_bytes_per_device(plan)

        traffic = (P / n) * (3.0 if self.kind == "train" else 1.0) \
            + self._act_bytes_per_device(plan) * 2.0
        if self.kind == "decode":
            traffic += self._kv_bytes_per_device(plan)  # full KV read/step
        t_memory = traffic / HW["hbm_bw"]

        # ---- collectives (per device bytes / interconnect bw, ``ici_bw``)
        coll = 0.0
        d_bytes = c.d_model * 2.0
        if "tp" in plan.strategy:
            # 2 all-reduces per layer fwd (+2 bwd): B_loc×T×d each
            n_ar = 2 * (2 if self.kind == "train" else 1)
            coll += n_ar * c.n_layers * tok_dev * d_bytes * \
                2.0 * (m.model - 1) / m.model
        if plan.strategy in ("fsdp", "fsdp_tp", "fsdp_tp_ep") \
                and self.kind == "train":
            regather = 2.0   # fwd + bwd weight all-gather
            P_regather = P
            if plan.strategy == "fsdp_tp_ep":
                # expert weights are fully OWNED (E on model × ffn on data):
                # never regathered — instead the (E_loc, C, d) activation
                # buffer reduces over data (≈ tok·topk·d·cf bytes per layer)
                P_regather = P - self._expert_bytes()
                n_moe = c.n_layers - c.n_dense_layers
                # per-device reduce of the (E/model, C, d) buffer over data
                buf = tok_dev * c.top_k * d_bytes * c.capacity_factor \
                    * n_moe / max(1, m.model)
                coll += buf * (3.0 if self.kind == "train" else 1.0)
            coll += regather * P_regather / max(
                1, m.model if "tp" in plan.strategy else 1)
        if self.kind == "train":
            # gradient reduce-scatter + param all-gather over data axis
            coll += 2.0 * P / max(1, m.model if "tp" in plan.strategy else 1) \
                * (m.dp - 1) / m.dp
        if c.moe and plan.moe_mode == "ep_all_to_all":
            n_moe = c.n_layers - c.n_dense_layers
            a2a = tok_dev * c.top_k * d_bytes * 2.0 * n_moe  # there and back
            coll += a2a * (3.0 if self.kind == "train" else 1.0)
        if plan.seq_shard and c.attn_kind != "none":
            # ring attention: KV blocks permute around the data axis
            coll += tok_dev * c.n_kv_heads * c.hd * 2.0 * 2.0 * c.n_layers
        t_coll = coll / HW["ici_bw"]

        feasible = resident <= HW["hbm_bytes"] * 0.9
        return {"compute_s": t_compute, "memory_s": t_memory,
                "collective_s": t_coll, "resident_bytes": resident,
                "feasible": feasible,
                "step_s": max(t_compute, t_memory, t_coll)}

    def _kv_bytes_per_device(self, plan: PlanChoice) -> float:
        c = self.cfg
        B, T = self.B, self.T
        if c.ssm_kind == "rwkv6":
            per = c.n_layers * c.n_heads * (c.d_model // c.n_heads) ** 2 * 4.0
            return B * per / self.mesh.dp
        if c.ssm_kind == "mamba2":
            per = c.n_layers * c.n_heads * c.ssm_state * \
                (2 * c.d_model // c.n_heads) * 4.0
            kv = B * per
            if c.shared_attn:
                sites = max(1, c.n_layers // max(1, c.hybrid_every))
                kv += sites * B * T * c.n_kv_heads * c.hd * 2 * 2.0
            return kv / self.mesh.dp
        # attention KV: batch over data AND sequence over model (the launch
        # cache_specs sharding) → divides by the full device count
        if c.attn_kind == "mla":
            per_tok = c.n_layers * (c.kv_lora_rank + c.qk_rope_dim) * 2.0
            return B * T * per_tok / self.mesh.n
        eff = min(T, c.window) if c.window else T
        per_tok = c.n_layers * c.n_kv_heads * c.hd * 2 * 2.0
        return B * eff * per_tok / self.mesh.n


# --------------------------------------------------------------------------
# Plan enumeration through the Region DAG
# --------------------------------------------------------------------------

def _dimension_rules(cfg: ArchConfig, kind: str) -> Dict[str, List]:
    dims = {
        "layout": (["fsdp_tp_ep", "fsdp_tp", "tp", "fsdp", "dp"]
                   if cfg.moe else ["fsdp_tp", "tp", "fsdp", "dp"]),
        "remat": (["none", "dots", "full"] if kind == "train" else ["none"]),
        "microbatch": ([1, 4, 8, 16] if kind == "train"
                       else ([1, 4] if kind == "prefill" else [1])),
        "seq_shard": [False, True] if kind == "decode" else [False],
        "moe_mode": (["ep_all_to_all", "replicated"] if cfg.moe else ["none"]),
    }
    return dims


def enumerate_plans(cfg: ArchConfig, kind: str) -> List[PlanChoice]:
    dims = _dimension_rules(cfg, kind)
    out = []
    for combo in itertools.product(dims["layout"], dims["remat"],
                                   dims["microbatch"], dims["seq_shard"],
                                   dims["moe_mode"]):
        out.append(PlanChoice(*combo))
    return out


def plan(cfg: ArchConfig, seq_len: int, global_batch: int, kind: str,
         mesh: Tuple[int, ...] = (1, 16, 16), top_k: int = 1):
    """Cost-based plan selection through the Region DAG.

    The step program's regions become memo groups; each planning dimension's
    alternatives are AND-nodes added by a rule (one rule per dimension —
    exactly the Fig. 11 pattern); the root 'assemble' enumerates child
    combinations and the cost model prices each complete plan. Volcano
    duplicate detection collapses re-derived combinations."""
    ms = MeshShape(*((1,) * (3 - len(mesh)) + tuple(mesh)))
    cm = TPUCostModel(cfg, seq_len, global_batch, kind, ms)

    memo = Memo()
    dims = _dimension_rules(cfg, kind)
    dim_groups = {}
    for dim, options in dims.items():
        g = None
        for opt in options:
            g, _ = memo.insert(AndNode(f"dim:{dim}", (), (dim, opt)), group=g)
        dim_groups[dim] = g
    root, _ = memo.insert(AndNode(
        "plan-assemble", tuple(dim_groups[d] for d in dims), "step"))

    # exhaustive cost over the AND-OR combination space (small; memoized)
    best: List[Tuple[float, PlanChoice, Dict]] = []
    for combo in itertools.product(*[
            [memo.node(a).payload[1] for a in memo.members(dim_groups[d])]
            for d in dims]):
        choice = PlanChoice(*combo)
        t = cm.terms(choice)
        cost = t["step_s"] if t["feasible"] else float("inf")
        best.append((cost, choice, t))
    best.sort(key=lambda x: x[0])
    if top_k == 1:
        cost, choice, t = best[0]
        return {"choice": choice, "terms": t, "cost_s": cost,
                "n_alternatives": len(best),
                "memo": memo.stats()}
    return [{"choice": c, "terms": t, "cost_s": s} for s, c, t in best[:top_k]]
