"""The examples' twins (``examples/*_torch.py``) against the reference
examples, on the CPU.

Each twin runs with ``--device cpu`` and is held against its reference
example run in this process:

  * quickstart, serve_programs: the printed lines are equal once the
    wall-clock fields (``…ms``, ``…µs``, the plan store's temporary path)
    are masked; the figures each twin returns agree with what it printed
    and with what the reference example asserts (a plan-cache hit, 0 memo
    runs in session B, the drift flip to prefetch, compiled = interpreted,
    the hot shard);
  * plan_distributed: each of the five cells' top-3 reports equals the
    reference's, with the reference's ``HW`` pinned in the port (the twin
    plans for one H100 by default);
  * serve_lm: the twin's completions equal the reference ``Server``'s on
    the reference's parameters cast to fp32 and carried across with
    ``carry.params_from_numpy`` (as ``test_torch_lm.py`` does);
  * train_lm: ``--steps 2`` finishes with finite losses.

And no twin imports ``repro`` or ``jax``; without CUDA, a twin run without
``--device cpu`` raises (the card is its default).

The twins run with torch's intra-op threads cut to 2 (restored after):
on a loaded CPU, bf16 ops on every core wait on one another and the
100M-parameter training step runs ten times slower.
"""

import ast
import contextlib
import importlib.util
import io
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TWINS = ("quickstart", "serve_programs", "plan_distributed", "serve_lm",
         "train_lm")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def few_threads(n=2):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), few_threads():
        out = fn(*args, **kw)
    return buf.getvalue(), out


def masked(text):
    """The printed lines without their wall-clock fields."""
    text = re.sub(r"cobra_plans_\w+", "cobra_plans_<tmp>", text)
    text = re.sub(r"\s*[0-9.]+(ms|µs)", " <t>", text)
    return text.splitlines()


def test_no_twin_imports_the_reference_or_jax():
    for name in TWINS:
        path = os.path.join(EXAMPLES, f"{name}_torch.py")
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in mods if m.split(".")[0] in ("repro", "jax")]
        assert not bad, (name, bad)
        assert any(m.startswith("repro_torch") for m in mods), name


@pytest.mark.parametrize("name", TWINS)
def test_twin_without_cuda_raises_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card, which is here")
    mod = load(f"{name}_torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main([])


def test_quickstart_prints_the_reference_lines():
    want, _ = printed(load("quickstart").main)
    got, fig = printed(load("quickstart_torch").main, ["--device", "cpu"])
    assert masked(got) == masked(want)
    assert [c["plan"] for c in fig["cells"]] == ["P1 (SQL join)",
                                                  "P2 (prefetch)"]
    for c in fig["cells"]:
        assert c["identical"] and c["cache_hits"] == 1
        assert c["simulated_s"] < c["baseline_simulated_s"]
    assert fig["analyze_flip"] == {"before": "P1 (SQL join)",
                                   "after": "P2 (prefetch)",
                                   "recompiled": True, "flipped": True}


def test_serve_programs_prints_the_reference_lines():
    want, _ = printed(load("serve_programs").main)
    got, fig = printed(load("serve_programs_torch").main, ["--device", "cpu"])
    assert masked(got) == masked(want)
    assert fig["store"]["session_b_memo_runs"] == 0
    assert fig["drift"]["p0_prefetch"] and fig["drift"]["recompiles"] >= 1
    tier = fig["compiled_tier"]
    assert tier["tiers"][0] == "interpreter" and \
        tier["tiers"][-1] == "compiled" and tier["identical"]
    assert fig["cluster"]["hot_shard_requests"] == 48
    assert fig["cluster"]["skew"] == 4.0


def test_plan_distributed_reports_equal_the_reference_with_its_hw():
    from repro.analysis import roofline as jroofline
    from repro.api import CobraSession as RefSession
    from repro.programs import make_orders_customer_db
    from repro_torch.analysis.roofline import HW
    twin = load("plan_distributed_torch")
    saved = dict(HW)
    HW.clear()
    HW.update(jroofline.HW)
    try:
        got, fig = printed(twin.main, ["--device", "cpu"])
    finally:
        HW.clear()
        HW.update(saved)
    session = RefSession(make_orders_customer_db(10, 10))
    for arch, kind, T, B in twin.CELLS:
        want = [twin.report_figures(r) for r in session.plan_step(
            arch, T, B, kind, mesh=(1, 16, 16), top_k=3)]
        assert fig[f"{arch}/{kind}"] == want, (arch, kind)
    assert got.splitlines()[0].startswith("planner hardware")


def test_serve_lm_completions_equal_the_reference_server():
    from repro.launch.serve import ServeConfig, Server
    from repro_torch.carry import params_from_numpy
    from repro_torch.models import get_arch
    twin = load("serve_lm_torch")
    jserver = Server(ServeConfig(**twin.CONFIG))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jserver.params)
    jserver.params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts = twin.make_prompts(jserver.arch.vocab_size)
    want = jserver.generate(prompts)
    cfg = get_arch(twin.CONFIG["arch"]).scaled()
    _, fig = printed(twin.main, ["--device", "cpu"],
                     params=params_from_numpy(tree, cfg, "cpu"))
    assert fig["completions"] == want
    assert fig["new_tokens"] == 6 * 24 and fig["requests"] == 6


def test_train_lm_takes_two_steps_with_finite_losses(tmp_path):
    _, fig = printed(load("train_lm_torch").main,
                     ["--device", "cpu", "--steps", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert fig["finite"] and len(fig["losses"]) >= 1
    assert all(math.isfinite(l) for _, l in fig["losses"])
