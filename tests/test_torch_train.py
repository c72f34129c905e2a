"""The port's training loop on the CPU: ``tests/test_trainer.py`` on the
port, and its data and checkpoints against the JAX package's.

  * the loop: the loss falls on the structured stream; a failure at step 7
    resumes from the step-5 checkpoint bit-identical to an uninterrupted
    run; microbatches 4 give the loss of one batch; a 1×1 mesh trains to
    the no-mesh losses, a mesh larger than the process group raises, and
    ``strategy`` without a mesh is ignored (the reference's behaviour);
    the CLI;
  * checkpoints: atomic commits and ``keep`` retention, a shape mismatch
    raising, the layout (stacks on a leading axis, bf16 stored as fp32 and
    named ``"bfloat16"``); and interchange both ways: the reference's
    ``Checkpointer`` save of its parameters and AdamW state restores in
    the port and gives the reference's ``loss_fn`` value, and a port save
    has the reference's manifest keys, shapes and dtypes and restores in
    the reference (AdamW's and Adafactor's states alike);
  * data: ``SyntheticLM`` batches equal the reference's bit for bit over
    several (seed, index, rank, count) combinations, deterministic and
    shardable; ``Prefetcher`` state resumes; the int8 gradient compression
    round trip.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models.model import loss_fn as jloss_fn
from repro.optim import optimizers as jopt
from repro_torch.carry import (opt_state_from_numpy, opt_state_to_numpy,
                               params_from_numpy, params_to_numpy)
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import PipelineConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import get_arch, loss_fn
from repro_torch.optim import (adafactor, adamw, compress_int8,
                               compressed_accumulate, decompress_int8,
                               tree_leaves, warmup_cosine)

DANUBE = "h2o-danube-1.8b"


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def cpu(**kw):
    return TrainConfig(device="cpu", **kw)


# --------------------------------------------------------------------------
# the loop (test_trainer.py on the port)
# --------------------------------------------------------------------------

def test_loss_decreases_on_structured_stream():
    out = train(cpu(arch=DANUBE, steps=60, global_batch=8, seq_len=32,
                    log_every=10), progress=lambda _: None)
    losses = [l for _, l in out["losses"]]
    # per-batch noise: require the best later loss to clearly beat the start
    assert min(losses[2:]) < losses[0] - 0.05, losses


def test_failure_injection_and_bitwise_resume(tmp_path):
    """Crash at step 7, restart, and land bit-identical to an uninterrupted
    run — checkpoint covers params, opt state, and the data cursor."""
    common = dict(arch=DANUBE, steps=12, global_batch=4, seq_len=32,
                  ckpt_every=5, log_every=100)
    quiet = lambda _: None   # noqa: E731
    ref = train(cpu(**common, ckpt_dir=str(tmp_path / "ref")), quiet)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cpu(**common, ckpt_dir=crash_dir, fail_at=7), quiet)
    seen = []
    resumed = train(cpu(**common, ckpt_dir=crash_dir), seen.append)
    assert seen[0] == "[resume] step 5"
    assert resumed["final_step"] == 12
    assert _leaves_equal(ref["params"], resumed["params"])


def test_microbatched_step_matches_single_batch():
    """grad accumulation over microbatches == one big batch (linear loss)."""
    quiet = lambda _: None   # noqa: E731
    out1 = train(cpu(arch=DANUBE, steps=3, global_batch=8, seq_len=16,
                     microbatch=1, log_every=1), quiet)
    out2 = train(cpu(arch=DANUBE, steps=3, global_batch=8, seq_len=16,
                     microbatch=4, log_every=1), quiet)
    l1 = dict(out1["losses"])[3]
    l2 = dict(out2["losses"])[3]
    assert abs(l1 - l2) < 0.05, (l1, l2)


@pytest.mark.parametrize("knob", [{"compress": True}])
def test_sharding_knobs_wait_for_the_ports_sharding(knob):
    """``compress`` (int8 gradient compression between devices) is a flag
    the reference never reads; the port raises rather than train as if it
    were unset."""
    with pytest.raises(NotImplementedError, match="never reads"):
        train(cpu(steps=1, **knob))


@pytest.fixture
def one_rank_group():
    """An in-process gloo group of one rank (world size 1)."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import _free_port
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}",
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_1x1_trains_to_the_no_mesh_losses(one_rank_group):
    """On a 1×1 mesh every DTensor holds its whole tensor: the losses are
    the no-mesh run's, bit for bit."""
    common = dict(arch=DANUBE, steps=3, global_batch=4, seq_len=16,
                  log_every=1)
    quiet = lambda _: None   # noqa: E731
    want = train(cpu(**common), quiet)
    got = train(cpu(**common, mesh_shape=(1, 1), strategy="fsdp_tp"), quiet)
    assert got["losses"] == want["losses"]
    assert _leaves_equal([t.full_tensor() for t in tree_leaves(got["params"])],
                         want["params"])


def test_strategy_without_a_mesh_trains_as_dp():
    """The reference reads ``strategy`` only with a mesh; without one,
    ``fsdp`` trains as ``dp`` does."""
    common = dict(arch=DANUBE, steps=2, global_batch=4, seq_len=16,
                  log_every=1)
    quiet = lambda _: None   # noqa: E731
    a = train(cpu(**common, strategy="fsdp"), quiet)
    b = train(cpu(**common), quiet)
    assert a["losses"] == b["losses"]
    assert _leaves_equal(a["params"], b["params"])


def test_mesh_larger_than_the_world_raises(one_rank_group):
    with pytest.raises(ValueError, match="world of 4 processes, the process "
                                         "group has 1"):
        train(cpu(steps=1, mesh_shape=(2, 2)))


def test_step_fn_prefill_and_decode_steps_match_forward():
    from repro_torch.launch.specs import step_fn
    from repro_torch.models import forward, init_params, make_caches
    cfg = get_arch(DANUBE).scaled()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(6)[None].expand(2, 6)
    want, _, _ = forward(params, cfg, toks, pos)
    got = step_fn(cfg, "prefill")(params, {"tokens": toks, "positions": pos})
    torch.testing.assert_close(got, want)
    caches = make_caches(cfg, 2, 8, dtype=torch.float32, device="cpu")
    forward(params, cfg, toks[:, :5], pos[:, :5], caches=caches,
            cache_index=0)
    nxt, _ = step_fn(cfg, "decode")(params, caches, 5,
                                    {"tokens": toks[:, 5:],
                                     "positions": pos[:, 5:]})
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, torch.argmax(want[:, -1], dim=-1).to(torch.int32))


def test_cli_trains_on_the_cpu(capsys):
    train_mod.main(["--device", "cpu", "--steps", "3", "--log-every", "1",
                    "--global-batch", "2", "--seq-len", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 3 and len(out["losses"]) == 3


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_atomic_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
    for step in (1, 2, 3):
        ck.save(step, tree, extras={"data": {"next_index": step}}, block=True)
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert names == ["step_00000002", "step_00000003"]  # keep=2
    assert ck.latest_step() == 3
    step, restored, extras = ck.restore(tree)
    assert step == 3 and extras["data"]["next_index"] == 3
    assert _leaves_equal(tree, restored)


def test_async_save_snapshots_before_in_place_updates(tmp_path, monkeypatch):
    """An async save holds the tree as it was at ``save``: the next step's
    in-place updates (AdamW's moments, ``p.copy_``) made while the writer
    runs do not reach the checkpoint, on the CPU too."""
    import threading
    released = threading.Event()
    savez = np.savez

    def held_savez(*a, **kw):   # the writer waits until the tree has moved
        assert released.wait(30)
        return savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held_savez)
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "layers": [{"m": torch.ones(3)} for _ in range(2)],
            "b": torch.ones(4).bfloat16()}
    before = {"w": tree["w"].clone(),
              "layers": [{"m": lay["m"].clone()} for lay in tree["layers"]],
              "b": tree["b"].clone()}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    tree["w"].mul_(-1.0)
    tree["b"].add_(1.0)
    for lay in tree["layers"]:
        lay["m"].add_(5.0)
    released.set()
    ck.wait()
    _, back, _ = ck.restore(tree)
    assert _leaves_equal(back, before)


def test_checkpoint_restore_rejects_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones((4, 4))}, block=True)
    with pytest.raises(ValueError):
        ck.restore({"w": torch.ones((5, 4))})
    # a stack of the wrong depth too
    ck.save(2, {"layers": [{"w": torch.ones(3)}] * 2}, block=True)
    with pytest.raises(ValueError, match="layers/w"):
        ck.restore({"layers": [{"w": torch.ones(3)}] * 3})


def test_checkpoint_stores_stacks_and_widened_bf16(tmp_path):
    tree = {"layers": [{"w": torch.full((2, 3), float(i)).bfloat16()}
                       for i in range(4)], "n": torch.ones(5)}
    Checkpointer(str(tmp_path)).save(7, tree, block=True)
    d = tmp_path / "step_00000007"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["keys"] == ["layers/w", "n"]
    assert manifest["shapes"] == {"layers/w": [4, 2, 3], "n": [5]}
    assert manifest["dtypes"] == {"layers/w": "bfloat16", "n": "float32"}
    arrays = np.load(d / "arrays.npz")
    assert arrays["layers/w"].dtype == np.float32
    assert (arrays["layers/w"][:, 0, 0] == [0, 1, 2, 3]).all()
    _, back, _ = Checkpointer(str(tmp_path)).restore(tree)
    assert _leaves_equal(tree, back)


def _reference_state(jcfg, seed=0):
    """The reference's bf16 parameters and an AdamW state one update in."""
    jparams = jinit_params(jax.random.PRNGKey(seed), jcfg)
    opt = jopt.adamw(jopt.warmup_cosine(3e-4, 2, 10))
    state = opt.init(jparams)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01, jparams)
    _, state = opt.update(grads, state, jparams, 1)
    return jparams, state


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, cfg = jget_arch(DANUBE).scaled(), get_arch(DANUBE).scaled()
    jparams, jstate = _reference_state(jcfg)
    JCheckpointer(str(tmp_path)).save(3, {"params": jparams, "opt": jstate},
                                      extras={"data": {"next_index": 3}},
                                      block=True)
    # the port's template: its own freshly drawn parameters and state
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jinit_params(
            jax.random.PRNGKey(9), jcfg)), cfg, "cpu")
    state = adamw(warmup_cosine(3e-4, 2, 10)).init(params)
    step, tree, extras = Checkpointer(str(tmp_path)).restore(
        {"params": params, "opt": state})
    assert step == 3 and extras == {"data": {"next_index": 3}}
    want_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    assert _leaves_equal(tree["params"], want_p)
    want_s = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                  cfg, "cpu")
    assert _leaves_equal(tree["opt"], want_s)
    # the restored parameters give the reference's loss
    b = JSyntheticLM(JPipelineConfig(global_batch=2, seq_len=16,
                                     vocab_size=cfg.vocab_size)).batch(0)
    want = jloss_fn(jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = loss_fn(tree["params"], cfg, {k: torch.from_numpy(v.copy())
                                            for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_port_checkpoint_has_the_reference_layout_and_restores_there(
        tmp_path, kind):
    jcfg, cfg = jget_arch(DANUBE).scaled(), get_arch(DANUBE).scaled()
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    lr = (3e-4, 2, 10)
    jopt_ = getattr(jopt, kind)(jopt.warmup_cosine(*lr))
    opt = (adamw if kind == "adamw" else adafactor)(warmup_cosine(*lr))
    jstate, state = jopt_.init(jparams), opt.init(params)
    Checkpointer(str(tmp_path / "port")).save(
        4, {"params": params, "opt": state}, extras={"data": {"next_index": 4}},
        block=True)
    JCheckpointer(str(tmp_path / "ref")).save(
        4, {"params": jparams, "opt": jstate},
        extras={"data": {"next_index": 4}}, block=True)
    mine, theirs = ((tmp_path / d / "step_00000004" / "manifest.json")
                    .read_text() for d in ("port", "ref"))
    assert json.loads(mine) == json.loads(theirs)
    step, tree, extras = JCheckpointer(str(tmp_path / "port")).restore(
        {"params": jparams, "opt": jstate})
    assert step == 4 and extras["data"]["next_index"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves({"params": jparams,
                                               "opt": jstate})):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_carry_round_trips_parameters_and_optimizer_state():
    jcfg, cfg = jget_arch(DANUBE).scaled(), get_arch(DANUBE).scaled()
    jparams, jstate = _reference_state(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg, "cpu")
    back = params_to_numpy(params, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    st = jax.tree_util.tree_map(np.asarray, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(
            opt_state_to_numpy(opt_state_from_numpy(st, cfg, "cpu"), cfg)),
            jax.tree_util.tree_leaves(st)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        params_to_numpy({"layers": params["layers"][:1]}, cfg)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,index,rank,count,emb,enc_dec", [
    (0, 0, 0, 1, None, False), (3, 5, 0, 1, None, False),
    (3, 5, 1, 2, None, False), (7, 11, 3, 4, 16, False),
    (1, 2, 0, 2, None, True), (2**31 - 1, 1000, 1, 2, 8, True)])
def test_synthetic_batches_equal_the_reference(seed, index, rank, count, emb,
                                               enc_dec):
    kw = dict(global_batch=8, seq_len=24, vocab_size=97, seed=seed,
              shard_rank=rank, shard_count=count, emb_dim=emb,
              enc_dec=enc_dec)
    got = SyntheticLM(PipelineConfig(**kw)).batch(index)
    want = JSyntheticLM(JPipelineConfig(**kw)).batch(index)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_deterministic_and_shardable():
    cfg = PipelineConfig(global_batch=8, seq_len=16, vocab_size=100, seed=3)
    a = SyntheticLM(cfg).batch(5)
    b = SyntheticLM(cfg).batch(5)
    assert np.array_equal(a["tokens"], b["tokens"])
    # shards partition the global batch deterministically and disjointly
    s0 = SyntheticLM(PipelineConfig(global_batch=8, seq_len=16, vocab_size=100,
                                    seed=3, shard_rank=0, shard_count=2)).batch(5)
    s1 = SyntheticLM(PipelineConfig(global_batch=8, seq_len=16, vocab_size=100,
                                    seed=3, shard_rank=1, shard_count=2)).batch(5)
    assert s0["tokens"].shape == (4, 16) and s1["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_prefetcher_resume_state():
    cfg = PipelineConfig(global_batch=2, seq_len=8, vocab_size=50)
    src = SyntheticLM(cfg)
    p = Prefetcher(src, depth=2)
    p.get()
    st = p.state()
    p.close()
    p2 = Prefetcher.restore(src, st)
    nxt = p2.get()
    p2.close()
    assert np.array_equal(nxt["tokens"], src.batch(st["next_index"])["tokens"])


def test_gradient_compression_roundtrip():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    q, s = compress_int8(g)
    assert q.dtype == torch.int8
    err = torch.max(torch.abs(decompress_int8(q, s) - g))
    assert float(err) <= float(s) * 0.51 + 1e-6  # half-ulp of the int8 grid
    # error feedback drives the accumulated estimate toward the true sum
    acc = torch.zeros_like(g)
    e = torch.zeros_like(g)
    for _ in range(8):
        acc, e = compressed_accumulate(acc, g, e)
    rel = float(torch.linalg.norm(acc - 8 * g) / torch.linalg.norm(8 * g))
    assert rel < 0.01
    # the same grid as the reference's
    jq, js = jopt.compress_int8(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
