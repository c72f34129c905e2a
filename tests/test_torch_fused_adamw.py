"""The train step's fused optimizer (``kernels.adamw``: the global norm,
then AdamW's clipped update and apply in one pass) and its dispatch.

On the CPU:

  * the train step takes the eager clip, ``optimizer.update`` and apply
    (spans ``train.clip``, ``train.update``, ``train.apply``; ``fused``
    False; no launch) on the CPU, under a one-rank mesh (DTensor leaves),
    and with Adafactor even where the leaves were on the card;
  * where the leaves are on the card, AdamW takes the fused pass:
    ``train.clip`` around the norm and the scale, ``train.update`` around
    the update, ``fused`` True (the kernels replaced by stand-ins that
    record their arguments), every gradient handed over contiguous, one
    that autograd gave as a view included;
  * the wrapper's checks raise on what the kernels do not take, and the
    step raises with them: it does not fall back;
  * the chunk table covers every element once, in an order fixed by the
    leaves' sizes.

The tests marked ``cuda`` run on the card (the module imports neither jax
nor the reference package: ``python3 -m pytest -q -m cuda
tests/test_torch_fused_adamw.py``):

  * the fused pass leaves m, v and p bit-identical to the eager path given
    the same clip scale, for bf16 and fp32 parameters and gradients, at
    danube's leaf shapes and ragged sizes, the clip on and off;
  * the norm within 1e-5 of an fp64 norm, the same bits on a second call;
  * three train steps fused against eager: the first loss bit-identical,
    every parameter within one bf16 spacing, the spans' shape, two
    launches a step; a one-rank mesh on the card stays eager.
"""

import bisect
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as fused_adamw
from repro_torch.launch import specs
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                         make_policy, param_specs)
from repro_torch.launch.specs import make_optimizer, make_train_step
from repro_torch.models import get_arch, init_params
from repro_torch.models.layers import NullPolicy
from repro_torch.obs import trace
from repro_torch.optim.optimizers import (adafactor, adamw, clip_scale,
                                          tree_leaves, warmup_cosine)

ARCH = "h2o-danube-1.8b"
EAGER = ["train.clip", "train.update", "train.apply"]
FUSED = ["train.clip", "train.update"]
# one danube layer's leaf shapes (its norms fp32), then ragged sizes: not
# multiples of the 8-element vector, of a chunk, one past a chunk
DANUBE_SHAPES = [(2560,), (2560, 2560), (2560, 640), (2560, 640),
                 (2560, 2560), (2560,), (2560, 13824), (6912, 2560)]
RAGGED = [(1,), (7,), (9,), (4095,), (fused_adamw.CHUNK + 1,), (100003,),
          (3, 5, 7)]
TYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def program():
    """The program recorder, recording every span, emptied before and
    after."""
    before = trace.program_tracing("on")
    trace.PROGRAM.reset()
    yield trace.PROGRAM
    trace.program_tracing(before)
    trace.PROGRAM.reset()


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _batch(cfg, device, seed=0, rows=2, seq=16):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, seq))
                               .astype(np.int32), device=device)
            for k in ("tokens", "labels")}


def _optimizer_span(program):
    (opt,) = program.spans("train.optimizer")
    return opt, [c.name for c in opt.children]


# --------------------------------------------------------------------------
# the CPU: dispatch, checks, the chunk table
# --------------------------------------------------------------------------

def _cpu_step(optimizer=None, policy=None, wrap=None):
    cfg = get_arch(ARCH).scaled()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg, "cpu")
    opt = optimizer(cfg) if optimizer else make_optimizer(cfg)
    pol = policy or NullPolicy()
    if wrap:
        params, batch, pol = wrap(cfg, params, batch)
    return make_train_step(cfg, pol, opt)(params, opt.init(params), 5, batch)


def _one_rank_mesh(cfg, params, batch):
    mesh = make_mesh((1, 1), ("data", "model"))
    dp = distribute_tree(mesh, param_specs(params, cfg, mesh, "fsdp_tp"),
                         params)
    db = distribute_tree(mesh, batch_specs(mesh, batch), batch)
    assert fused_adamw._problem(tree_leaves(dp)) == "a DTensor"
    return dp, db, make_policy(mesh, "fsdp_tp")


def _adafactor(cfg):
    return adafactor(warmup_cosine(3e-4, 10, 100))


@pytest.mark.parametrize("case", ["cpu", "dtensor", "adafactor"])
def test_the_step_stays_eager_off_the_card(program, monkeypatch, case):
    fused_adamw.launches = 0
    if case == "dtensor":
        with fake_group(1):
            _cpu_step(wrap=_one_rank_mesh)
    elif case == "adafactor":
        # the leaves count as on the card: Adafactor has no fused pass
        monkeypatch.setattr(specs, "_on_card", lambda leaf: True)
        assert _adafactor(None).fused is None
        _cpu_step(optimizer=_adafactor)
    else:
        assert make_optimizer(get_arch(ARCH).scaled()).fused is not None
        _cpu_step()
    opt, children = _optimizer_span(program)
    assert opt.attrs == {"fused": False} and children == EAGER
    assert fused_adamw.launches == 0


def _stand_ins(monkeypatch, calls):
    """The kernels' wrapper replaced by stand-ins that record their
    arguments, the leaves counted as on the card."""
    def leaves(grads, params, m, v):
        calls.append(("leaves", len(grads), len(params), len(m), len(v),
                      all(g.is_contiguous() for g in grads)))
        return "leaves"

    def norm(leaves):
        calls.append(("norm", leaves))
        return torch.tensor(4.0)

    def update(leaves, scale, **scalars):
        calls.append(("update", leaves, float(scale), scalars))

    monkeypatch.setattr(specs, "_on_card", lambda leaf: True)
    monkeypatch.setattr(fused_adamw, "Leaves", leaves)
    monkeypatch.setattr(fused_adamw, "global_norm", norm)
    monkeypatch.setattr(fused_adamw, "adamw_update", update)


def test_adamw_takes_the_fused_pass_where_the_check_passes(program,
                                                           monkeypatch):
    calls = []
    _stand_ins(monkeypatch, calls)
    _, _, step, metrics = _cpu_step()
    opt, children = _optimizer_span(program)
    assert opt.attrs == {"fused": True} and children == FUSED
    n = len(tree_leaves(init_params(torch.Generator().manual_seed(0),
                                    get_arch(ARCH).scaled())))
    (_, *lens, contiguous), norm, (_, leaves, scale, scalars) = calls
    assert lens == [n] * 4 and contiguous
    assert norm == ("norm", "leaves") and leaves == "leaves"
    assert scale == 0.25 and metrics["grad_norm"] == 4.0 and step == 6
    t = torch.tensor(6.0)          # step 5 + 1, as the update takes it
    assert scalars == dict(
        lr=float(warmup_cosine(3e-4, 200, 10000)(5)), b1=0.9, b2=0.95,
        eps=1e-8, weight_decay=0.1,
        bc1=float(1 - torch.tensor(0.9, dtype=torch.float32) ** t),
        bc2=float(1 - torch.tensor(0.95, dtype=torch.float32) ** t))


def test_the_fused_pass_gets_contiguous_gradients(program, monkeypatch):
    """A gradient that autograd hands back as a view that is not
    contiguous reaches the fused pass contiguous, with its values."""
    grads = specs._grads
    seen = {}

    def transposed(*args, **kwargs):
        loss, gs = grads(*args, **kwargs)
        i = next(i for i, g in enumerate(gs) if g.dim() == 2)
        seen["index"], seen["value"] = i, gs[i].clone()
        gs = list(gs)
        gs[i] = gs[i].t().contiguous().t()
        assert not gs[i].is_contiguous()
        return loss, tuple(gs)

    def leaves(gs, params, m, v):
        seen["contiguous"] = all(g.is_contiguous() for g in gs)
        seen["got"] = gs[seen["index"]]
        return "leaves"

    _stand_ins(monkeypatch, [])
    monkeypatch.setattr(specs, "_grads", transposed)
    monkeypatch.setattr(fused_adamw, "Leaves", leaves)
    _cpu_step()
    assert seen["contiguous"] and torch.equal(seen["got"], seen["value"])


def test_the_step_raises_where_the_fused_pass_cannot_take_a_leaf(
        program, monkeypatch):
    """Leaves counted as on the card that the kernels do not take (here,
    on the CPU) make the step raise: it does not fall back to the eager
    path."""
    monkeypatch.setattr(specs, "_on_card", lambda leaf: True)
    fused_adamw.launches = 0
    with pytest.raises(ValueError, match="a tensor on cpu"):
        _cpu_step()
    (opt,) = program.spans("train.optimizer")
    assert opt.attrs == {"fused": True}
    assert fused_adamw.launches == 0


def _leaves(n=3, dtype=torch.float32, device="cpu"):
    return [torch.zeros(5, 8, dtype=dtype, device=device) for _ in range(n)]


def _bad(case):
    """(what the wrapper is called with, the message it must raise)."""
    g, p, m, v = (_leaves() for _ in range(4))
    if case == "on the cpu":
        return (g, p, m, v), "a tensor on cpu"
    if case == "fp16":
        g[0] = g[0].half()
        return (g, p, m, v), "torch.float16"
    if case == "bf16 moments":
        m[2] = m[2].bfloat16()
        return (g, p, m, v), "moments"
    if case == "not contiguous":
        g[0] = torch.zeros(8, 5).t()
        return (g, p, m, v), "not contiguous"
    if case == "base off 16 bytes":
        g[0] = torch.zeros(41)[1:].view(5, 8)
        return (g, p, m, v), "16-byte"
    if case == "shapes":
        p[0] = torch.zeros(8, 5)
        return (g, p, m, v), "shapes"
    if case == "lengths":
        return (g, p[:2], m, v), "3 gradients against 2"
    return ([], [], [], []), "no leaves"


@pytest.mark.parametrize("case", ["on the cpu", "fp16", "bf16 moments",
                                  "not contiguous", "base off 16 bytes",
                                  "shapes", "lengths", "empty"])
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(case):
    (g, p, m, v), message = _bad(case)
    fused_adamw.launches = 0
    with pytest.raises(ValueError, match=message):
        fused_adamw.Leaves(g, p, m, v)
    if case not in ("bf16 moments", "shapes", "lengths"):
        with pytest.raises(ValueError, match=message):
            fused_adamw.Leaves(g)
    assert fused_adamw.launches == 0


SIZES = [[1], [fused_adamw.CHUNK], [fused_adamw.CHUNK + 1, 7, 3 * 2 ** 20],
         [2560] * 49 + [2560 * 2560] * 48 + [2560 * 13824] * 24,
         [5] * 5000]


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: f"{len(s)}-leaves")
def test_the_chunk_table_covers_every_element_once(sizes):
    """The norm's walk over ``launch_shape``: block b takes chunks b,
    b + blocks, ..., a chunk's leaf the last whose first chunk is at most
    it; every element of every leaf is visited once. (The update's grid
    is one block a chunk: the same walk with ``blocks == chunks``.)"""
    shape = fused_adamw.launch_shape(sizes)
    assert shape == fused_adamw.launch_shape(list(sizes))   # sizes alone
    assert shape.chunks == sum(-(-n // fused_adamw.CHUNK) for n in sizes)
    assert shape.blocks == min(shape.chunks, 792)
    seen = [0] * shape.chunks
    covered = [[] for _ in sizes]
    for b in range(shape.blocks):
        for c in range(b, shape.chunks, shape.blocks):
            seen[c] += 1
            leaf = bisect.bisect_right(shape.chunk0, c) - 1
            start = (c - shape.chunk0[leaf]) * fused_adamw.CHUNK
            stop = min(start + fused_adamw.CHUNK, sizes[leaf])
            assert start % 8 == 0 and start < stop
            covered[leaf].append((start, stop))
    assert seen == [1] * shape.chunks
    for n, spans in zip(sizes, covered):
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_the_table_rows_skip_empty_leaves():
    g = [torch.zeros(3), torch.zeros(0), torch.zeros(fused_adamw.CHUNK + 1,
                                                     dtype=torch.bfloat16)]
    p = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(0),
         torch.zeros(fused_adamw.CHUNK + 1)]
    m, v = ([torch.zeros(t.shape) for t in g] for _ in range(2))
    rows, shape = fused_adamw._rows(g, p, m, v)
    assert shape.chunk0 == [0, 1] and shape.chunks == 3
    assert rows == [g[0].data_ptr(), p[0].data_ptr(), m[0].data_ptr(),
                    v[0].data_ptr(), 3, 0, 0, 1,
                    g[2].data_ptr(), p[2].data_ptr(), m[2].data_ptr(),
                    v[2].data_ptr(), fused_adamw.CHUNK + 1, 1, 1, 0]
    rows, _ = fused_adamw._rows(g)
    assert rows[1:4] == [0, 0, 0] and rows[7] == 0


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def _state(cuda, g_dtype, p_dtype, grad_std, seed=0):
    """Seeded gradients, parameters and moments at DANUBE_SHAPES + RAGGED
    (the 1-d danube leaves fp32 parameters and gradients, as danube's
    norms), a stretch of each gradient exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = {k: [] for k in ("g", "p", "m", "v")}
    for i, shape in enumerate(DANUBE_SHAPES + RAGGED):
        norm = i < len(DANUBE_SHAPES) and len(shape) == 1
        gt, pt = (torch.float32,) * 2 if norm else (g_dtype, p_dtype)
        n = lambda: torch.randn(shape, generator=gen, device=cuda)  # noqa: E731
        g = n() * grad_std
        g.view(-1)[: g.numel() // 5] = 0
        out["g"].append(g.to(gt))
        out["p"].append((n() * 0.02).to(pt))
        out["m"].append(n() * grad_std * 0.1)
        out["v"].append(n().square() * grad_std ** 2 * 0.01)
    return out


def _clone(state):
    return {k: [t.clone() for t in ts] for k, ts in state.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("p_type", sorted(TYPES))
@pytest.mark.parametrize("g_type", sorted(TYPES))
def test_the_fused_pass_is_bit_identical_to_eager(cuda, g_type, p_type,
                                                  clip):
    """Given the fused norm's clip scale, the fused update leaves m, v and
    p bit-identical to the eager path: ``clip_by_global_norm``'s scaling
    of each gradient by that scale, ``adamw``'s update, the train step's
    apply."""
    opt = adamw(warmup_cosine(3e-4, 10, 100))
    state = _state(cuda, TYPES[g_type], TYPES[p_type],
                   1e-3 if clip else 1e-5)
    eager, fused = _clone(state), _clone(state)
    step = 7
    norm, update = opt.fused(fused["g"], {"m": fused["m"], "v": fused["v"]},
                             fused["p"], step)
    scale = clip_scale(norm(), 1.0)
    assert (float(scale) < 0.5) == clip and (float(scale) == 1.0) != clip
    fused_adamw.launches = 0
    update(scale)
    assert fused_adamw.launches == 1
    with torch.no_grad():
        for g in eager["g"]:        # clip_by_global_norm's scaling
            g.copy_((g.float() * scale).to(g.dtype))
        updates, _ = opt.update(eager["g"], {"m": eager["m"],
                                             "v": eager["v"]},
                                eager["p"], step)
        for p, u in zip(eager["p"], updates):   # the train step's apply
            p.copy_((p.float() + u.float()).to(p.dtype))
    torch.cuda.synchronize()
    for k in ("m", "v", "p"):
        for i, (a, b) in enumerate(zip(fused[k], eager[k])):
            diff = (a != b).sum().item()
            assert diff == 0, (k, i, tuple(a.shape), diff)
    for a, b in zip(fused["g"], state["g"]):
        assert torch.equal(a, b)            # the gradients are not written
    assert any(not torch.equal(a, b) for a, b in zip(fused["p"], state["p"]))


@pytest.mark.cuda
@pytest.mark.parametrize("g_type", sorted(TYPES))
def test_the_norm_matches_fp64_and_repeats(cuda, g_type):
    grads = _state(cuda, TYPES[g_type], torch.float32, 1e-3)["g"]
    grads.append(torch.full((fused_adamw.CHUNK * 3 + 5,), 3.0, device=cuda))
    exact = sum(float((g.double() ** 2).sum()) for g in grads) ** 0.5
    leaves = fused_adamw.Leaves(grads)
    first = fused_adamw.global_norm(leaves)
    again = fused_adamw.global_norm(fused_adamw.Leaves(grads))
    assert first.dtype == torch.float32 and first.shape == ()
    assert abs(float(first) - exact) <= 1e-5 * exact
    assert torch.equal(first, again)


def _steps(cuda, fused: bool, steps=3):
    cfg = get_arch(ARCH).scaled()
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    opt = make_optimizer(cfg, total_steps=100)
    if not fused:
        opt = dataclasses.replace(opt, fused=None)
    state = opt.init(params)
    fn = make_train_step(cfg, NullPolicy(), opt)
    losses, norms = [], []
    fused_adamw.launches = 0
    for i in range(steps):
        params, state, _, metrics = fn(params, state, 5 + i,
                                       _batch(cfg, cuda, seed=i, rows=4,
                                              seq=64))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return params, losses, norms, fused_adamw.launches


@pytest.mark.cuda
def test_three_fused_train_steps_follow_the_eager_ones(cuda, program):
    eager, e_losses, e_norms, e_launches = _steps(cuda, fused=False)
    spans = [(s.attrs, [c.name for c in s.children])
             for s in program.spans("train.optimizer")]
    assert spans == [({"fused": False}, EAGER)] * 3 and e_launches == 0
    program.reset()
    fused, f_losses, f_norms, f_launches = _steps(cuda, fused=True)
    spans = [(s.attrs, [c.name for c in s.children])
             for s in program.spans("train.optimizer")]
    assert spans == [({"fused": True}, FUSED)] * 3
    assert f_launches == 2 * 3
    assert all(s.device_ms > 0 for s in program.spans("train.update"))
    assert f_losses[0] == e_losses[0]
    for a, b in zip(f_norms, e_norms):
        assert abs(a - b) <= 1e-5 * b
    for a, b in zip(tree_leaves(fused), tree_leaves(eager)):
        big = torch.maximum(a.float().abs(), b.float().abs())
        spacing = torch.ldexp(torch.ones_like(big),
                              torch.frexp(big)[1] - 8)
        assert ((a.float() - b.float()).abs() <= spacing).all()


@pytest.mark.cuda
def test_a_one_rank_mesh_on_the_card_stays_eager(cuda, program):
    from repro_torch.launch.mesh import card_group
    cfg = dataclasses.replace(get_arch(ARCH).scaled(), n_layers=2)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    batch = _batch(cfg, cuda)
    opt = make_optimizer(cfg)
    fused_adamw.launches = 0
    with card_group():
        dp, db, pol = _one_rank_mesh(cfg, params, batch)
        make_train_step(cfg, pol, opt)(dp, opt.init(dp), 5, db)
    opt_span, children = _optimizer_span(program)
    assert opt_span.attrs == {"fused": False} and children == EAGER
    assert fused_adamw.launches == 0

