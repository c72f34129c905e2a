"""COBRA on an NVIDIA GPU: cost-based rewriting of database applications
(Emani & Sudarshan, 2018), the PyTorch / CUDA port of the ``repro`` package.

The public surface is the session API, as in the reference package::

    from repro_torch.api import CobraSession, OptimizerConfig, ProgramBuilder, q
    from repro_torch.core import CostCatalog
    from repro_torch.programs import make_orders_customer_db, make_p0
    from repro_torch.relational import SLOW_REMOTE

    db = make_orders_customer_db(2_880_404, 100_000)   # tables on the card
    session = CobraSession(db, CostCatalog(SLOW_REMOTE))
    exe = session.compile(make_p0())     # memo search once, plan cached
    out = exe.run_batch([{}] * 4, tier="compiled")   # compiled tier

Tables live on one device: the card by default (``device=None`` without
CUDA raises; tests pass ``device="cpu"``). The compiled tier's probes and
accumulator folds run the hand-written CUDA kernels of
:mod:`repro_torch.kernels` on the card, their plain torch versions on the
CPU. ``repro_torch.carry.database_from_numpy`` loads numpy tables (for
instance exported from the reference package) into a server.

This package mirrors ``repro`` module for module and imports none of it.
Ported so far: the compile -> batch -> compiled-tier path, the serving loop
(feedback re-optimization, plan diagnostics), the sharded cluster, LM
serving of all ten registered architectures (dense GQA/SWA with RoPE or
M-RoPE, MLA, RWKV6, Mamba2 / Zamba2, MoE, encoder-decoder) and the step
planner behind ``session.plan_step`` (costed for one H100 by default).

  repro_torch.api         — CobraSession, OptimizerConfig, ProgramBuilder, PlanCache
  repro_torch.runtime     — run_batch, SiteCache, PlanStore, ServingRuntime,
                            FeedbackController
  repro_torch.cluster     — ShardedDatabase, ClusterRuntime (router + batch former)
  repro_torch.obs         — tracing, metrics, explain_plan, scan_plan, triage_fleet
  repro_torch.core        — the paper: regions, F-IR, Region DAG, rules, search
  repro_torch.compiled    — the compiled execution tier
  repro_torch.relational  — columnar torch tables + simulated DB environment
  repro_torch.kernels     — CUDA kernels for Hopper (+ plain torch versions)
  repro_torch.models      — LM architectures, layers, forward; launch.serve
  repro_torch.analysis    — roofline terms (HW table) and report renderers
"""

__version__ = "1.2.0"
