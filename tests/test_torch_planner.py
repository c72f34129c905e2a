"""The port's step planner and its ``CobraSession.plan_step`` facade against
the JAX package, on the CPU.

The planner, the roofline terms and the report renderers are pure Python
in both packages; the port's ``analysis.roofline.HW`` defaults to one
NVIDIA H100 SXM, the reference's to its own device. Every parity test
below pins the reference's ``HW`` values into the port (read from
``repro.analysis.roofline.HW`` at test time, either through
``ExecutionContext.hw`` or by overlaying the port's table for the length
of the test) and then expects the reference's choice, cost, alternatives,
memo statistics and top-k list exactly: the same arithmetic on the same
numbers. Mirrors ``tests/test_api.py::TestPlannerFacade``,
``tests/test_context.py::TestContextHWProfile`` and the planner tests of
``tests/test_system.py``; the renderers (``analysis/report.py``,
``analysis/perf_report.py``) must give the same text from the same JSON.
"""

import contextlib
import dataclasses
import json

import pytest

from repro.analysis import perf_report as jperf_report
from repro.analysis import report as jreport
from repro.analysis import roofline as jroofline
from repro.api import CobraSession as JSession
from repro.configs import SHAPES as JSHAPES
from repro.core import planner as jplanner
from repro.models.arch import get_arch as jget_arch
from repro.programs import make_orders_customer_db as jmake_db
from repro_torch.analysis import perf_report, report, roofline
from repro_torch.analysis.roofline import HW
from repro_torch.api import CobraSession, PlanReport
from repro_torch.configs import ALL_ARCHS, SHAPES
from repro_torch.core import ExecutionContext, planner
from repro_torch.core.planner import (MeshShape, PlanChoice, TPUCostModel,
                                      enumerate_plans, plan)
from repro_torch.models.arch import get_arch
from repro_torch.programs import make_orders_customer_db, make_wilos_db


@contextlib.contextmanager
def reference_hw():
    """The port's HW table holding the reference's values, restored after."""
    saved = dict(HW)
    HW.clear()
    HW.update(jroofline.HW)
    try:
        yield
    finally:
        HW.clear()
        HW.update(saved)


def session(**kw):
    return CobraSession(make_orders_customer_db(10, 10, device="cpu"), **kw)


def pinned_session():
    """A port session whose context pins the reference's HW profile."""
    return session(context=ExecutionContext(hw=dict(jroofline.HW)))


def same_choice(port_choice, ref_choice):
    return dataclasses.astuple(port_choice) == dataclasses.astuple(ref_choice)


# --------------------------------------------------------------------------
# the hardware table
# --------------------------------------------------------------------------

def test_default_hw_is_the_h100_profile_with_the_reference_keys():
    assert set(HW) == set(jroofline.HW)
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                  "ici_bw": 450e9, "hbm_bytes": 80e9}
    assert planner.HW is HW and roofline.HW is HW


def test_reference_hw_overlay_restores_the_port_table():
    before = dict(HW)
    with reference_hw():
        assert HW == jroofline.HW
    assert HW == before


# --------------------------------------------------------------------------
# the session facade (tests/test_api.py::TestPlannerFacade)
# --------------------------------------------------------------------------

class TestPlannerFacade:
    def test_plan_step_matches_core_planner(self):
        rep = pinned_session().plan_step("stablelm-12b", 2048, 64, "train")
        with reference_hw():
            raw = plan(get_arch("stablelm-12b"), 2048, 64, "train")
        assert isinstance(rep, PlanReport) and rep.domain == "step"
        assert rep.choice == raw["choice"]
        assert rep.est_cost_s == pytest.approx(raw["cost_s"])
        assert rep.alternatives == raw["n_alternatives"]

    def test_plan_step_matches_the_reference_session(self):
        rep = pinned_session().plan_step("stablelm-12b", 2048, 64, "train")
        want = JSession(jmake_db(10, 10)).plan_step("stablelm-12b", 2048, 64,
                                                    "train")
        assert rep.name == want.name == "stablelm-12b/train/T2048/B64"
        assert same_choice(rep.choice, want.choice)
        assert rep.est_cost_s == want.est_cost_s
        assert rep.alternatives == want.alternatives
        assert rep.memo_stats == want.memo_stats
        assert rep.artifact == want.artifact

    def test_plan_step_keyed_on_hardware_profile(self):
        s = session()
        r1 = s.plan_step("rwkv6-3b", 1024, 4, "decode")
        old = HW["hbm_bw"]
        try:
            HW["hbm_bw"] = old / 4
            r2 = s.plan_step("rwkv6-3b", 1024, 4, "decode")
            assert r2 is not r1          # fresh planning pass, not the memo
            r3 = s.plan_step("rwkv6-3b", 1024, 4, "decode")
            assert r3 is r2              # memoized under the NEW profile
        finally:
            HW["hbm_bw"] = old
        assert s.plan_step("rwkv6-3b", 1024, 4, "decode") is r1

    def test_plan_step_memoized_and_topk(self):
        s = pinned_session()
        r1 = s.plan_step("rwkv6-3b", 1024, 4, "decode")
        r2 = s.plan_step("rwkv6-3b", 1024, 4, "decode")
        assert r1 is r2  # facade memoizes identical cells
        top3 = s.plan_step("rwkv6-3b", 1024, 4, "decode", top_k=3)
        assert len(top3) == 3
        want = JSession(jmake_db(10, 10)).plan_step("rwkv6-3b", 1024, 4,
                                                    "decode", top_k=3)
        assert [dataclasses.astuple(r.choice) for r in top3] == \
            [dataclasses.astuple(r.choice) for r in want]
        assert [r.est_cost_s for r in top3] == [r.est_cost_s for r in want]
        assert [r.alternatives for r in top3] == [r.alternatives for r in want]

    def test_plan_step_takes_an_arch_config(self):
        s = pinned_session()
        cfg = get_arch("minicpm3-4b")
        rep = s.plan_step(cfg, 4096, 8, "prefill", mesh=(1, 4, 4))
        want = JSession(jmake_db(10, 10)).plan_step(
            jget_arch("minicpm3-4b"), 4096, 8, "prefill", mesh=(1, 4, 4))
        assert same_choice(rep.choice, want.choice)
        assert rep.est_cost_s == want.est_cost_s


# --------------------------------------------------------------------------
# a context-pinned HW profile (tests/test_context.py::TestContextHWProfile)
# --------------------------------------------------------------------------

class TestContextHWProfile:
    def test_pinned_hw_changes_step_plan_cost_and_restores_global(self):
        base = CobraSession(make_wilos_db(50, device="cpu"))
        ref = base.plan_step("rwkv6-3b", 2048, 16, "train")

        slow = CobraSession(make_wilos_db(50, device="cpu"),
                            context=ExecutionContext(
                                hw={"peak_flops": HW["peak_flops"] / 10}))
        before = dict(HW)
        out = slow.plan_step("rwkv6-3b", 2048, 16, "train")
        assert HW == before                      # overlay fully restored
        assert out.est_cost_s > ref.est_cost_s   # the pin really costed it
        # distinct HW profiles occupy distinct step-cache entries
        assert slow.plan_step("rwkv6-3b", 2048, 16, "train") is out

    def test_pinned_reference_profile_gives_the_reference_cost(self):
        before = dict(HW)
        out = pinned_session().plan_step("rwkv6-3b", 2048, 16, "train")
        assert HW == before
        want = JSession(jmake_db(10, 10)).plan_step("rwkv6-3b", 2048, 16,
                                                    "train")
        assert same_choice(out.choice, want.choice)
        assert out.est_cost_s == want.est_cost_s

    def test_an_added_key_leaves_the_table(self):
        s = session(context=ExecutionContext(hw={"nvlink_lanes": 18.0}))
        s.plan_step("rwkv6-3b", 1024, 4, "decode")
        assert "nvlink_lanes" not in HW


# --------------------------------------------------------------------------
# the planner (tests/test_system.py::TestPlanner), under the reference's HW
# --------------------------------------------------------------------------

def test_shapes_and_archs_are_the_reference_s():
    from repro.configs import ALL_ARCHS as JALL
    assert ALL_ARCHS == JALL and SHAPES == JSHAPES


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_shape_plans_as_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape, spec in SHAPES.items():
        if shape == "long_500k" and not cfg.subquadratic:
            continue
        args = (spec["seq_len"], spec["global_batch"], spec["kind"])
        with reference_hw():
            out = plan(cfg, *args, mesh=(1, 16, 16))
            top = plan(cfg, *args, mesh=(1, 16, 16), top_k=5)
        want = jplanner.plan(jcfg, *args, mesh=(1, 16, 16))
        want_top = jplanner.plan(jcfg, *args, mesh=(1, 16, 16), top_k=5)
        assert out["terms"]["feasible"], (arch, shape, out["choice"])
        assert same_choice(out["choice"], want["choice"]), (arch, shape)
        assert out["cost_s"] == want["cost_s"]
        assert out["terms"] == want["terms"]
        assert out["n_alternatives"] == want["n_alternatives"]
        assert out["memo"] == want["memo"]
        assert [(dataclasses.astuple(c["choice"]), c["cost_s"]) for c in top] \
            == [(dataclasses.astuple(c["choice"]), c["cost_s"])
                for c in want_top]


def test_enumerated_plans_are_the_reference_s():
    for arch in ALL_ARCHS:
        for kind in ("train", "prefill", "decode"):
            got = [dataclasses.astuple(p)
                   for p in enumerate_plans(get_arch(arch), kind)]
            want = [dataclasses.astuple(p)
                    for p in jplanner.enumerate_plans(jget_arch(arch), kind)]
            assert got == want, (arch, kind)


def test_moe_prefers_all_to_all_for_many_experts():
    cfg = get_arch("kimi-k2-1t-a32b")
    with reference_hw():
        out = plan(cfg, 4096, 256, "train", mesh=(1, 16, 16))
    assert out["choice"].moe_mode == "ep_all_to_all"


def test_dp_infeasible_for_1t_params():
    cfg = get_arch("kimi-k2-1t-a32b")
    with reference_hw():
        cm = TPUCostModel(cfg, 4096, 256, "train", MeshShape(1, 16, 16))
        dp = cm.terms(PlanChoice("dp", "full", 8, False, "ep_all_to_all"))
    assert not dp["feasible"]  # replicated 1T params >> the device memory


def test_remat_tradeoff_visible():
    cfg = get_arch("stablelm-12b")
    with reference_hw():
        cm = TPUCostModel(cfg, 4096, 256, "train", MeshShape(1, 16, 16))
        none = cm.terms(PlanChoice("fsdp_tp", "none", 8, False, "none"))
        full = cm.terms(PlanChoice("fsdp_tp", "full", 8, False, "none"))
    assert full["compute_s"] > none["compute_s"]
    assert full["resident_bytes"] < none["resident_bytes"]


def test_multi_pod_scales_compute_term():
    cfg = get_arch("internlm2-20b")
    with reference_hw():
        one = plan(cfg, 4096, 256, "train", mesh=(1, 16, 16))
        two = plan(cfg, 4096, 256, "train", mesh=(2, 16, 16))
    assert two["terms"]["compute_s"] < one["terms"]["compute_s"]


def test_one_card_plans_the_served_minicpm3_prefill():
    # under the default (H100) profile on a one-card mesh: feasible, and
    # every term from the H100 table
    out = plan(get_arch("minicpm3-4b"), 4608, 4, "prefill", mesh=(1, 1, 1))
    assert out["terms"]["feasible"] and out["cost_s"] < float("inf")
    cm = TPUCostModel(get_arch("minicpm3-4b"), 4608, 4, "prefill",
                      MeshShape(1, 1, 1))
    t = cm.terms(out["choice"])
    assert t["compute_s"] == pytest.approx(
        cm._flops_total(out["choice"]) / 989e12)


# --------------------------------------------------------------------------
# roofline terms and the renderers
# --------------------------------------------------------------------------

HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), dimensions={0}
  %ar-start = (f32[1024]{0}, f32[1024]{0}) all-reduce-start(f32[1024]{0} %x)
  %ar-done = f32[1024]{0} all-reduce-done(%ar-start)
  %rs = f32[64,8]{1,0} reduce-scatter(f32[1024,8]{1,0} %y), dimensions={0}
  %a2a = s32[8,128]{1,0} all-to-all(s32[8,128]{1,0} %z), dimensions={0}
  %cp = bf16[2,2]{1,0} collective-permute(bf16[2,2]{1,0} %w)
"""


def test_collective_bytes_from_hlo_matches_reference():
    got = roofline.collective_bytes_from_hlo(HLO)
    assert got == jroofline.collective_bytes_from_hlo(HLO)
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 1}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_terms_match_reference(kind):
    spec = {"kind": kind, "seq_len": 4096, "global_batch": 64}
    cell = {"n_devices": 256, "flops_per_device": 3.1e15,
            "bytes_per_device": 7.7e11,
            "collectives": {"bytes_per_device": 2.2e10}}
    with reference_hw():
        got = roofline.roofline_terms(get_arch("llama4-scout-17b-a16e"),
                                      spec, cell)
    assert got == jroofline.roofline_terms(
        jget_arch("llama4-scout-17b-a16e"), spec, cell)


def _dryrun_cells(tmp_path):
    cells = [
        {"arch": "stablelm-12b", "shape": "train_4k", "mesh": "16x16",
         "status": "ok", "roofline": {"compute_s": 1.5, "memory_s": 0.02,
                                      "collective_s": 3e-4,
                                      "dominant": "compute_s",
                                      "useful_flops_ratio": 0.71,
                                      "roofline_fraction": 0.456},
         "full_compile": {"memory": {"total_hbm_bytes": 12.3e9}},
         "full_collective_counts": {"all-gather": 4, "all-reduce": 2}},
        {"arch": "stablelm-12b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped"},
        {"arch": "h2o-danube-1.8b", "shape": "decode_32k", "mesh": "16x16",
         "status": "ok", "roofline": {"compute_s": 2e-6, "memory_s": 4e-4,
                                      "collective_s": 0.0,
                                      "dominant": "memory_s",
                                      "useful_flops_ratio": 0.5,
                                      "roofline_fraction": 0.01}},
        {"arch": "h2o-danube-1.8b", "shape": "prefill_32k", "mesh": "16x16",
         "status": "error"},
        {"arch": "rwkv6-3b", "shape": "train_4k", "mesh": "2x16x16",
         "status": "ok", "roofline": {}},
    ]
    for i, c in enumerate(cells):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(c))
    return str(tmp_path)


def test_report_renders_the_reference_text(tmp_path):
    out = _dryrun_cells(tmp_path)
    assert report.roofline_table(out) == jreport.roofline_table(out)
    assert report.roofline_table(out, mesh="2x16x16") == \
        jreport.roofline_table(out, mesh="2x16x16")
    assert report.dryrun_summary(out) == jreport.dryrun_summary(out)
    assert "| stablelm-12b | train_4k | 1.50s |" in report.roofline_table(out)


def test_perf_report_renders_the_reference_text(tmp_path):
    rec = {"pair": "A", "arch": "kimi-k2-1t-a32b", "shape": "train_4k",
           "iterations": [
               {"variant": "baseline", "status": "ok",
                "hypothesis": "collectives dominate | all-to-all",
                "terms": {"compute_s": 1.2, "memory_s": 0.3,
                          "collective_s": 2.4},
                "roofline_fraction": 0.21, "verdict": "baseline"},
               {"variant": "ep", "status": "ok",
                "hypothesis": "expert parallel halves the a2a",
                "terms": {"compute_s": 1.2, "memory_s": 0.3,
                          "collective_s": 1.1},
                "roofline_fraction": 0.35,
                "delta_on_baseline_dominant": -0.54, "verdict": "kept"},
               {"variant": "broken", "status": "error"}]}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    got = perf_report.perf_section(str(tmp_path))
    assert got == jperf_report.perf_section(str(tmp_path))
    assert "**ep**" in got and "(**2.18×**)" in got
