"""The port's training math against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through ``repro`` and
``repro_torch``:

  * ``lm_loss`` on the same logits and labels (-100 masked), and its
    gradient;
  * ``loss_fn`` and EVERY gradient leaf for all ten registered
    architectures at ``scaled()`` size: the reference's parameters cast to
    fp32 and carried with ``params_from_numpy``, against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; seamless-m4t in
    bf16 on both sides (the reference's encoder cannot run fp32
    parameters). The MoE models' routing must have no top-k tie at the
    seed (a near tie could route the two packages' tokens apart);
  * ``flash_attention_bwd_ref`` (the plain version beside the backward
    kernel) against torch autograd of ``flash_attention_ref`` and against
    ``jax.grad`` of the reference's ``sdpa`` under its ``_attn_mask`` (what
    the reference's training differentiates), over causal, window, chunk,
    unmasked and cross attention, GQA and hdv < hd;
  * AdamW and Adafactor over three steps (a stack of layers among the
    leaves, so Adafactor's stacked factoring shows), ``warmup_cosine`` and
    ``clip_by_global_norm``;
  * one ``make_train_step`` step of danube ``scaled()``: the loss, the
    gradient norm and the updated parameters.

Tolerances, as a fraction of each compared tensor's peak magnitude: fp32
1e-4 (two fp32 implementations summing in another order; the worst leaf
measured 3.5e-5, zamba2's chunked scan); bf16 (seamless) 4 * 2**-7, four
bf16 spacings at the peak (measured 2.2e-2); the loss itself 1e-5
relative in fp32, 1e-3 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.specs import make_optimizer as jmake_optimizer
from repro.launch.specs import make_train_step as jmake_train_step
from repro.models import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models.layers import NullPolicy as JNullPolicy
from repro.models.layers import _attn_mask as j_attn_mask
from repro.models.layers import sdpa as jsdpa
from repro.models.model import lm_loss as jlm_loss
from repro.models.model import loss_fn as jloss_fn
from repro.optim import optimizers as jopt
from repro_torch.carry import params_from_numpy, reference_leaves
from repro_torch.kernels import ref
from repro_torch.launch.specs import make_optimizer, make_train_step
from repro_torch.models import get_arch, layers, list_archs, lm_loss, loss_fn
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               tree_leaves, tree_map, warmup_cosine)

FP32_TOL = 1e-4
BF16_TOL = 4 * 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, np.float32)


def assert_peak_close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * peak + 1e-30, (what, err, peak)


def _ref_flat(tree):
    """The reference tree's leaves by '/'-joined key path."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    """The port tree's leaves by the reference's key paths, stacks on a
    leading axis."""
    return {"/".join(p): (np.stack([_np(t) for t in ts]) if stacked
                          else _np(ts[0]))
            for p, (ts, stacked) in reference_leaves(tree).items()}


# --------------------------------------------------------------------------
# lm_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_its_gradient_match_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, -1] = -100
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    want, want_g = jax.value_and_grad(
        lambda x: jlm_loss(x, jnp.asarray(labels)))(jl)
    x = torch.tensor(np.asarray(jl.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    got = lm_loss(x, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert_peak_close(x.grad, want_g, FP32_TOL if dtype == "float32"
                      else BF16_TOL)


def test_lm_loss_with_every_label_masked_is_zero():
    x = torch.randn(2, 3, 10)
    assert float(lm_loss(x, torch.full((2, 3), -100))) == 0.0


# --------------------------------------------------------------------------
# loss_fn and every gradient leaf, all ten architectures
# --------------------------------------------------------------------------

def _batch(cfg, B=2, T=16, seed=3):
    """Random tokens and labels (the last three masked), and frames for an
    encoder-decoder model."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    b["labels"][:, -3:] = -100
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    return b


def _carried(name, seed=0):
    """(reference cfg, reference params, port cfg, port params): fp32 but
    for the encoder-decoder model, bf16 as drawn on both sides."""
    jcfg, cfg = jget_arch(name).scaled(), get_arch(name).scaled()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = jinit_params(jax.random.PRNGKey(seed), jcfg)
    cast = (lambda a: np.asarray(a)) if cfg.enc_dec else \
        (lambda a: np.asarray(jnp.asarray(a, jnp.float32)))
    tree = jax.tree_util.tree_map(cast, tree)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, "cpu"))


def _port_value_and_grad(params, cfg, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, cfg, {k: torch.from_numpy(v.copy())
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return float(loss), tree_map(lambda _: next(it), params)


@pytest.mark.parametrize("name", list_archs())
def test_loss_and_every_gradient_leaf_match_reference(name, monkeypatch):
    jcfg, jparams, cfg, params = _carried(name)
    batch = _batch(cfg)
    margins = []
    if cfg.moe:   # record each token's gap between its k-th and next gate
        dispatch = layers.moe_dispatch

        def recording(p, xf, c, gate_idx=None):
            out = dispatch(p, xf, c, gate_idx)
            top = torch.sort(out[0].detach(), dim=-1, descending=True).values
            if c.top_k < c.n_experts:   # with k = E every expert is taken
                margins.append(float((top[:, c.top_k - 1]
                                      - top[:, c.top_k]).min()))
            return out
        monkeypatch.setattr(layers, "moe_dispatch", recording)
    loss, grads = _port_value_and_grad(params, cfg, batch)
    want, jgrads = jax.value_and_grad(lambda p: jloss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    bf16 = cfg.enc_dec
    np.testing.assert_allclose(loss, float(want), rtol=1e-3 if bf16 else 1e-5)
    got, ref_flat = _port_flat(grads), _ref_flat(jgrads)
    assert sorted(got) == sorted(ref_flat)
    for key, g in got.items():
        assert_peak_close(g, ref_flat[key], BF16_TOL if bf16 else FP32_TOL,
                          key)
    if cfg.moe:   # no near tie: fp32 differences are ~1e-7
        assert min(margins, default=1.0) > 1e-5, margins


# --------------------------------------------------------------------------
# flash attention's backward, the plain version
# --------------------------------------------------------------------------

# (B, H, KV, Tq, Tk, hd, hdv, causal, window, chunk)
BWD_CASES = [
    (2, 4, 2, 37, 37, 16, 16, True, None, None),     # causal, GQA
    (1, 4, 2, 40, 40, 24, 24, True, 8, None),        # sliding window
    (1, 2, 1, 33, 33, 16, 16, True, None, 8),        # chunk-local
    (1, 2, 2, 23, 23, 8, 8, False, None, None),      # unmasked (encoder)
    (1, 4, 4, 10, 23, 8, 8, False, None, None),      # cross, Tq < Tk
    (1, 4, 4, 23, 10, 8, 8, False, None, None),      # cross, Tq > Tk
    (1, 4, 2, 20, 50, 24, 16, True, 8, None),        # hdv < hd, tail queries
    (1, 4, 4, 30, 30, 24, 16, True, None, None),     # MLA-like, H = KV
]


def _bwd_inputs(B, H, KV, Tq, Tk, hd, hdv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Tk, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Tk, hdv)).astype(np.float32),
            rng.standard_normal((B, H, Tq, hdv)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,hdv,causal,window,chunk",
                         BWD_CASES)
def test_flash_attention_bwd_ref_matches_autograd(B, H, KV, Tq, Tk, hd, hdv,
                                                  causal, window, chunk):
    q, k, v, do = (torch.from_numpy(a).double().requires_grad_()
                   for a in _bwd_inputs(B, H, KV, Tq, Tk, hd, hdv))
    kw = dict(causal=causal, window=window, chunk=chunk)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    (o * do).sum().backward()
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), lse, do.detach(), **kw)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype
        assert_peak_close(g, x.grad, 1e-5)


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,hdv,causal,window,chunk",
                         BWD_CASES)
def test_flash_attention_bwd_ref_matches_reference_sdpa_grad(
        B, H, KV, Tq, Tk, hd, hdv, causal, window, chunk):
    """Against ``jax.grad`` of the reference's ``sdpa`` (layout (B, T,
    heads, dim)) under ``_attn_mask`` with the queries at the tail."""
    q, k, v, do = _bwd_inputs(B, H, KV, Tq, Tk, hd, hdv)
    mask = j_attn_mask(Tq, Tk, Tk - Tq, causal, window, chunk)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    jg = jax.grad(lambda a, b, c: jnp.sum(jsdpa(a, b, c, mask=mask) * tr(do)),
                  argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    kw = dict(causal=causal, window=window, chunk=chunk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                      torch.from_numpy(do), **kw)
    for g, w in zip(got, jg):
        assert_peak_close(g, np.asarray(w).transpose(0, 2, 1, 3), FP32_TOL)


def test_flash_attention_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = _bwd_inputs(1, 4, 2, 20, 30, 16, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ref.flash_attention_ref(tq, tk, tv, window=6, return_lse=True)
    torch.testing.assert_close(out, ref.flash_attention_ref(tq, tk, tv,
                                                            window=6))
    s = torch.einsum("bhqd,bhsd->bhqs", tq, tk.repeat_interleave(2, 1)) / 4
    m = ref._attention_mask(20, 30, True, 6, None, "cpu")
    want = torch.logsumexp(s.masked_fill(~m, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    # a row with every key masked: +inf, so exp(s - lse) is 0 there
    _, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, chunk=4,
                                     return_lse=True)
    assert torch.isfinite(lse).all()
    _, lse = ref.flash_attention_ref(tq[:, :2, :9], tk[:, :, :5],
                                     tv[:, :, :5], causal=True,
                                     return_lse=True)
    assert torch.isposinf(lse[..., :4]).all() and torch.isfinite(lse[..., 4:]).all()


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

def _opt_trees(seed=0, L=3):
    """A reference tree (a stack of L layers on a leading axis) and the
    port's (the stack a list), fp32 and bf16 leaves, matrices and
    vectors."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ref_tree = {"embed": {"tok": n(12, 8)}, "ln_f": n(8),
                "layers": {"w": n(L, 8, 6), "ln": n(L, 8),
                           "mlp": {"w_in": n(L, 6, 10)}}}
    bf = {"embed/tok", "layers/w"}

    def port_of(tree):
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        t = lambda key, a: torch.from_numpy(np.array(a)).to(  # noqa: E731
            torch.bfloat16 if key in bf else torch.float32)
        return {"embed": {"tok": t("embed/tok", flat["embed/tok"])},
                "ln_f": t("ln_f", flat["ln_f"]),
                "layers": [{"w": t("layers/w", flat["layers/w"][i]),
                            "ln": t("layers/ln", flat["layers/ln"][i]),
                            "mlp": {"w_in": t("layers/mlp/w_in",
                                              flat["layers/mlp/w_in"][i])}}
                           for i in range(L)]}

    def ref_of(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(a, jnp.bfloat16 if "/".join(
                str(k.key) for k in path) in bf else jnp.float32), tree)
    return ref_tree, ref_of, port_of


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_match_reference_over_three_steps(kind):
    ref_tree, ref_of, port_of = _opt_trees()
    lr_args = (1e-2, 2, 10)
    jo = getattr(jopt, kind)(jopt.warmup_cosine(*lr_args),
                             **({"weight_decay": 0.1} if kind == "adafactor"
                                else {}))
    po = (adamw if kind == "adamw" else adafactor)(
        warmup_cosine(*lr_args), **({"weight_decay": 0.1}
                                    if kind == "adafactor" else {}))
    jp, pp = ref_of(ref_tree), port_of(ref_tree)
    js, ps = jo.init(jp), po.init(pp)
    rng = np.random.default_rng(1)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), ref_tree)
        ju, js = jo.update(ref_of(g), js, jp, step)
        pu, ps = po.update(port_of(g), ps, pp, step)
        assert_flat_close(_port_flat(pu), _ref_flat(ju), "update")
        jp = jax.tree_util.tree_map(lambda p, u: (p.astype(jnp.float32) +
                                                  u.astype(jnp.float32)
                                                  ).astype(p.dtype), jp, ju)
        pp = tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                      pp, pu)
    assert_flat_close(_port_flat(pp), _ref_flat(jp), "params")
    # the state, in the reference's layout
    want = _ref_flat(js)
    got = {**{f"m/{k}": v for k, v in _port_flat(ps["m"]).items()},
           **{f"v/{k}": v for k, v in _port_flat(ps["v"]).items()}} \
        if kind == "adamw" else {
            "slots/" + k: v for k, v in _port_flat(ps["slots"]).items()}
    assert_flat_close(got, want, "state")


def assert_flat_close(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        tol = BF16_TOL if np.asarray(want[k]).dtype == jnp.bfloat16 \
            else FP32_TOL
        assert_peak_close(got[k], np.asarray(want[k], np.float32), tol,
                          f"{what} {k}")


def test_adafactor_factors_a_stack_of_vectors():
    # a stack of (8,) norm weights is one (3, 8) reference leaf: factored
    _, _, port_of = _opt_trees()
    ref_tree = _opt_trees()[0]
    slots = adafactor(warmup_cosine(1e-2, 2, 10)).init(port_of(ref_tree))
    assert sorted(slots["slots"]["layers"]["ln"]) == ["vc", "vr"]
    assert tuple(slots["slots"]["layers"]["ln"]["vr"].shape) == (3,)
    assert sorted(slots["slots"]["ln_f"]) == ["v"]


def test_warmup_cosine_and_clip_match_reference():
    jl, pl = jopt.warmup_cosine(3e-4, 10, 100), warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(pl(step)), float(jl(step)),
                                   rtol=1e-6)
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((5, 4)).astype(np.float32) * 3,
         "b": [{"c": rng.standard_normal(7).astype(np.float32)}]}
    jg, jn = jopt.clip_by_global_norm({"a": jnp.asarray(g["a"]),
                                       "b": [{"c": jnp.asarray(g["b"][0]["c"])}]},
                                      1.0)
    pg, pn = clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(_np(pg["a"]), np.asarray(jg["a"]), rtol=1e-6)
    np.testing.assert_allclose(_np(pg["b"][0]["c"]), np.asarray(jg["b"][0]["c"]),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------

def test_train_step_matches_reference():
    """One ``make_train_step`` step of danube ``scaled()`` in fp32 at step
    5 (past the warmup's zero learning rate): the loss, the gradient norm
    and the update of every leaf."""
    jcfg, jparams, cfg, params = _carried("h2o-danube-1.8b")
    before = _port_flat(params)
    batch = _batch(cfg, B=4, T=16, seed=5)
    jpol = JNullPolicy()
    jpol.microbatch = 1
    jo = jmake_optimizer(jcfg)
    jstep = jmake_train_step(jcfg, jpol, jo)
    jnew, _, jstep_out, jm = jstep(jparams, jo.init(jparams),
                                   jnp.asarray(5, jnp.int32),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    po = make_optimizer(cfg)
    pnew, _, step_out, m = make_train_step(cfg, optimizer=po)(
        params, po.init(params), 5,
        {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    assert step_out == int(jstep_out) == 6
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    got, want = _port_flat(pnew), _ref_flat(jnew)
    assert sorted(got) == sorted(want)
    for k in want:
        # each update within 1e-2 of the updates' peak, past the one fp32
        # rounding of p + u (an update ~4e-6 lands on a spacing of params
        # ~0.03): AdamW's first step is g / (|g| + eps), so an element
        # whose gradient is near eps moves with the gradient's last bits
        # (one element of 16,384 off by 2e-3 of the peak)
        w = np.asarray(want[k], np.float32)
        peak = float(np.abs(w - before[k]).max())
        err = np.abs(got[k] - w)
        bad = err > 1e-2 * peak + np.spacing(np.abs(w))
        assert not bad.any(), (k, float(err.max()), peak, int(bad.sum()))
