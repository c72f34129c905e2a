"""The port's Mamba2 / Zamba2, encoder-decoder and MoE models against the JAX
package, on the CPU.

The same numpy inputs (fixed seeds) go through ``repro`` and ``repro_torch``:

  * ``decay_linear_attention`` in its Mamba2 mode (``u`` None, one decay per
    head), from zero and from a given state, at T a multiple of the chunk,
    T not a multiple, T below one chunk and T = 1, and with ``u`` None and
    per-channel decay;
  * ``mamba2_block``, with and without a state;
  * ``moe``: outputs, aux loss and the dispatch (which assignments are
    dropped) for llama4-scout (top-1, shared expert) and kimi-k2 (top-8),
    at the published capacity factor and at 0.5, where experts overflow;
    and a router whose gates all tie, which ``jax.lax.top_k`` breaks
    towards the lower expert index;
  * ``forward`` logits and aux losses, prefill then decode equal to a full
    forward, the written caches, and ``Server.generate``, for zamba2-1.2b,
    llama4-scout-17b-a16e and kimi-k2-1t-a32b at ``arch.scaled()`` size,
    and for a Zamba2 whose depth leaves a tail after its last shared block,
    with the reference's parameters cast to fp32 on both sides and carried
    across by ``params_from_numpy``;
  * seamless-m4t-large-v2: ``forward`` with ``enc_inputs`` (the encoder)
    with and without caches and the decode steps after it, in bf16 on both
    sides (the reference's encoder cannot run fp32 parameters: its
    ``lax.scan`` carry turns from the bf16 frames to fp32); a decode step
    over a cross cache given in fp32; ``Server.generate``, which runs no
    encoder; and the reference's quirk that cross attention with caches
    runs over the whole S_max-long cross cache, unwritten zero slots
    included, so that T_enc < S_max gives other logits than no cache;
  * ``params_from_numpy`` on kimi-k2's ``dense_layers`` / ``layers`` split,
    seamless's ``enc`` / ``dec`` and Zamba2's ``shared_attn``; the port's own
    random parameters in the reference's tree; the caches of the full
    configurations.

Tolerances: layers, logits and caches 1e-4 in fp32 (two fp32
implementations of the same arithmetic, sums in another order), as in
``test_torch_models.py``; in bf16, four bf16 spacings at the compared
values' peak (both sides round in bf16 at other places; 2**-6 at logits
near 0.6, as ``test_torch_models.py`` holds bf16 logits).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import as_reference
from repro.launch import serve as jserve
from repro.models import forward as jforward
from repro.models import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import make_caches as jmake_caches
from repro_torch.carry import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import forward, get_arch, init_params, make_caches
from repro_torch.models import layers

LOGIT_TOL = 1e-4
ZAMBA, SEAMLESS = "zamba2-1.2b", "seamless-m4t-large-v2"
LLAMA4, KIMI = "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"
# zamba2 at smoke scale has 2 layers and a shared block after each; this
# depth and period leave one Mamba2 layer after the last site, as the
# published 38 layers with every = 6 leave 2
ZAMBA_TAIL = dict(n_layers=5, hybrid_every=2)


def torch_of(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def bf16_close(got, want):
    """Within four bf16 spacings at the peak magnitude of ``want``."""
    want = as_np(want)
    peak = float(np.abs(want).max())
    tol = 4 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    np.testing.assert_allclose(as_np(got), want, rtol=0, atol=tol)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _configs(name, **changes):
    """(reference cfg, port cfg) at smoke scale, with ``changes`` on both."""
    jcfg, cfg = (dataclasses.replace(c.scaled(), **changes)
                 for c in (jget_arch(name), get_arch(name)))
    return jcfg, as_reference(cfg, jcfg)


def _carried(jcfg, cfg, seed=0, fp32=True):
    """The reference's parameters (cast to fp32, or as drawn), on both sides."""
    tree = jinit_params(jax.random.PRNGKey(seed), jcfg)
    tree = _f32(tree) if fp32 else jax.tree_util.tree_map(np.asarray, tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, cfg, "cpu"))


def _tokens(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    return toks, pos


# --------------------------------------------------------------------------
# decay_linear_attention, Mamba2 mode
# --------------------------------------------------------------------------

def _scan_inputs(B, H, T, K, V, scalar, seed):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, H, T, K)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((B, H, T, V)).astype(np.float32)
    w = -np.exp(rng.standard_normal((B, H, T, 1 if scalar else K)) * 0.5 - 1)
    w = np.broadcast_to(w, (B, H, T, K)).astype(np.float32)
    state = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return r, k, v, w, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,scalar", [(256, True), (200, True), (40, True),
                                      (1, True), (50, False)])
def test_decay_linear_attention_mamba2_mode_matches_reference(T, scalar,
                                                              with_state):
    # T 256: two full 128-token chunks; 200: a padded second chunk; 40 and
    # 1: one chunk of T; scalar False: u None with per-channel decay
    r, k, v, w, state = _scan_inputs(2, 3, T, 8, 16, scalar, seed=T)
    st = state if with_state else None
    y, S = layers.decay_linear_attention(
        *(torch_of(a) for a in (r, k, v, w)),
        state=None if st is None else torch_of(st), scalar_decay=scalar)
    y0, S0 = jlayers.decay_linear_attention(
        *(jnp.asarray(a) for a in (r, k, v, w)),
        state=None if st is None else jnp.asarray(st), scalar_decay=scalar)
    assert y.shape == (2, 3, T, 16) and S.dtype == torch.float32
    close(y, y0, LOGIT_TOL)
    close(S, S0, LOGIT_TOL)


def test_decay_linear_attention_mamba2_mode_takes_a_given_chunk():
    r, k, v, w, state = _scan_inputs(1, 2, 70, 8, 8, True, seed=3)
    got = layers.decay_linear_attention(
        *(torch_of(a) for a in (r, k, v, w)), state=torch_of(state),
        chunk=16, scalar_decay=True)
    want = jlayers.decay_linear_attention(
        *(jnp.asarray(a) for a in (r, k, v, w)), state=jnp.asarray(state),
        chunk=16, scalar_decay=True)
    for a, b in zip(got, want):
        close(a, b, LOGIT_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [12, 1])
def test_mamba2_block_matches_reference(T, with_state):
    jcfg, cfg = _configs(ZAMBA)
    tree = _f32(jlayers.init_mamba2(jax.random.PRNGKey(4), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    H, dn, P = cfg.n_heads, cfg.ssm_state, 2 * cfg.d_model // cfg.n_heads
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    st = rng.standard_normal((2, H, dn, P)).astype(np.float32) \
        if with_state else None
    y, S = layers.mamba2_block(params, torch_of(x), cfg,
                               None if st is None else torch_of(st))
    y0, S0 = jlayers.mamba2_block(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jcfg,
        None if st is None else jnp.asarray(st))
    assert y.shape == (2, T, cfg.d_model) and S.shape == (2, H, dn, P)
    close(y, y0, LOGIT_TOL)
    close(S, S0, LOGIT_TOL)


def test_mamba2_block_keeps_the_reference_types():
    # bf16 weights and activations: the decay and state fp32, the output
    # bf16, as jnp's promotion gives them
    _, cfg = _configs(ZAMBA)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    bp = params["layers"][0]["mamba"]
    assert {k: str(t.dtype) for k, t in bp.items()} == {
        "w_in": "torch.bfloat16", "dt_bias": "torch.float32",
        "A_log": "torch.float32", "D": "torch.float32",
        "norm": "torch.float32", "w_out": "torch.bfloat16"}
    x = torch.randn(1, 5, cfg.d_model).bfloat16()
    y, S = layers.mamba2_block(bp, x, cfg)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _reference_dispatch(params, xf, cfg):
    """The reference's routing lines (``repro/models/layers.py:moe``):
    each (token, slot)'s expert and whether it was kept."""
    E, k = cfg.n_experts, cfg.top_k
    n = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ params["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    cap = int(max(8, math.ceil(n * k / E * cfg.capacity_factor)))
    flat = gate_idx.reshape(-1)
    order = jnp.argsort(flat)
    sorted_e = flat[order]
    seg_pos = jax.lax.associative_scan(jnp.add, jnp.ones_like(sorted_e)) - 1
    pos_sorted = seg_pos - jnp.searchsorted(sorted_e, jnp.arange(E))[sorted_e]
    pos = jnp.zeros_like(pos_sorted).at[order].set(pos_sorted)
    return np.asarray(flat), np.asarray(pos < cap)


def _moe_case(name, capacity_factor=None, zero_router=False, n=48):
    changes = {} if capacity_factor is None else \
        {"capacity_factor": capacity_factor}
    jcfg, cfg = _configs(name, **changes)
    tree = _f32(jlayers.init_moe(jax.random.PRNGKey(5), jcfg))
    if zero_router:   # every gate ties
        tree["router"] = np.zeros_like(tree["router"])
    params = params_from_numpy(tree, cfg, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    x = np.random.default_rng(6).standard_normal(
        (2, n // 2, cfg.d_model)).astype(np.float32)
    y, aux = layers.moe(params, torch_of(x), cfg)
    y0, aux0 = jlayers.moe(jp, jnp.asarray(x), jcfg)
    _, _, flat, keep, _, cap = layers.moe_dispatch(
        params, torch_of(x).reshape(n, -1), cfg)
    flat0, keep0 = _reference_dispatch(jp, jnp.asarray(x).reshape(n, -1), jcfg)
    return (y, aux, flat, keep, cap), (y0, aux0, flat0, keep0), cfg


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("name", [LLAMA4, KIMI])
def test_moe_matches_reference(name, capacity_factor):
    (y, aux, flat, keep, cap), (y0, aux0, flat0, keep0), cfg = \
        _moe_case(name, capacity_factor)
    np.testing.assert_array_equal(flat.numpy(), flat0)
    np.testing.assert_array_equal(keep.numpy(), keep0)
    if capacity_factor is not None:   # the case overflows: some dropped
        assert not keep.all()
    close(y, y0, LOGIT_TOL)
    close(aux, aux0, LOGIT_TOL)


@pytest.mark.parametrize("name", [LLAMA4, KIMI])
def test_moe_breaks_top_k_ties_towards_the_lower_expert(name):
    # a zero router: every gate is 1/E, and jax.lax.top_k picks experts
    # 0..k-1 for every token; their capacity overflows, and the kept
    # assignments are each expert's first in token order (a stable sort)
    (y, aux, flat, keep, cap), (y0, aux0, flat0, keep0), cfg = \
        _moe_case(name, zero_router=True)
    k = cfg.top_k
    np.testing.assert_array_equal(flat.numpy(), np.tile(np.arange(k), 48))
    np.testing.assert_array_equal(flat.numpy(), flat0)
    np.testing.assert_array_equal(keep.numpy(), keep0)
    if cap < 48:
        assert keep.view(48, k)[:cap].all() and not keep.view(48, k)[cap:].any()
    close(y, y0, LOGIT_TOL)
    close(aux, aux0, LOGIT_TOL)


def test_moe_dispatch_replays_given_experts():
    # gate_idx routes to given experts: the call's own top k reproduce its
    # dispatch exactly; other experts take the router's probabilities there
    # as their gates, renormalised, and fill the capacity in token order
    _, cfg = _configs(LLAMA4, capacity_factor=0.5)
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    p = {k: (v.float() if torch.is_tensor(v) else v) for k, v in p.items()}
    xf = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    own = layers.moe_dispatch(p, xf, cfg)
    again = layers.moe_dispatch(p, xf, cfg,
                                gate_idx=own[2].view(40, cfg.top_k))
    for a, b in zip(own, again):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    other = torch.zeros((40, cfg.top_k), dtype=torch.long)   # all expert 0
    probs, gates, flat, keep, dst, cap = layers.moe_dispatch(p, xf, cfg,
                                                             gate_idx=other)
    assert torch.equal(flat, torch.zeros(40, dtype=torch.long))
    assert torch.equal(keep, torch.arange(40) < cap)
    torch.testing.assert_close(gates, torch.ones(40, 1))   # top-1: renormalised


def test_moe_keeps_the_reference_types():
    _, cfg = _configs(KIMI)
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32
    assert p["w_in"].shape == (cfg.n_experts, cfg.d_model, 2 * cfg.moe_d_ff)
    assert p["w_in"].dtype == p["w_out"].dtype == torch.bfloat16
    y, aux = layers.moe(p, torch.randn(1, 6, cfg.d_model).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


# --------------------------------------------------------------------------
# models: zamba2, llama4-scout, kimi-k2 in fp32
# --------------------------------------------------------------------------

MODELS = {"zamba2": (ZAMBA, {}), "zamba2-tail": (ZAMBA, ZAMBA_TAIL),
          "llama4-scout": (LLAMA4, {}), "kimi-k2": (KIMI, {})}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(reference cfg, reference fp32 params, port cfg, port params)."""
    name, changes = MODELS[request.param]
    jcfg, cfg = _configs(name, **changes)
    jparams, params = _carried(jcfg, cfg)
    return jcfg, jparams, cfg, params


def test_forward_logits_and_aux_match_reference(model):
    jcfg, jparams, cfg, params = model
    toks, pos = _tokens(cfg, 2, 12)
    logits, caches, aux = forward(params, cfg, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
    want, _, aux0 = jforward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos))
    assert logits.shape == (2, 12, cfg.vocab_size) and caches is None
    close(logits, want, LOGIT_TOL)
    close(aux, aux0, LOGIT_TOL)
    assert (float(aux) > 0) == cfg.moe


def test_prefill_then_decode_matches_full_forward(model):
    jcfg, jparams, cfg, params = model
    B, P, T = 2, 5, 9
    toks, pos = (torch.from_numpy(a) for a in _tokens(cfg, B, T, seed=1))
    full, _, _ = forward(params, cfg, toks, pos)
    caches = make_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    logits, out, _ = forward(params, cfg, toks[:, :P], pos[:, :P],
                             caches=caches, cache_index=0)
    assert out is caches          # updated in place
    steps = [logits]
    for t in range(P, T):
        lg, caches, _ = forward(params, cfg, toks[:, t:t + 1],
                                pos[:, t:t + 1], caches=caches, cache_index=t)
        steps.append(lg)
    if not cfg.moe:   # an MoE full forward drops other assignments
        close(torch.cat(steps, dim=1), full, LOGIT_TOL)
    # the reference's caches after the same steps: entries, shapes, contents
    jc = jmake_caches(jcfg, B, T, dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in caches.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    jsteps = []
    for lo, hi in [(0, P)] + [(t, t + 1) for t in range(P, T)]:
        lg, jc, _ = jforward(jparams, jcfg, jnp.asarray(toks[:, lo:hi].numpy()),
                             jnp.asarray(pos[:, lo:hi].numpy()), caches=jc,
                             cache_index=lo)
        jsteps.append(lg)
    close(torch.cat(steps, dim=1), jnp.concatenate(jsteps, axis=1), LOGIT_TOL)
    for key in caches:
        close(caches[key], jc[key], LOGIT_TOL)


def test_server_generate_matches_reference(model):
    jcfg, jparams, cfg, params = model
    scfg = serve.ServeConfig(arch=cfg.name, max_new_tokens=5, max_seq=32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 3)]
    server = serve.Server(scfg, params=params, device="cpu")
    server.arch = cfg
    jserver = jserve.Server(jserve.ServeConfig(arch=cfg.name, max_new_tokens=5,
                                               max_seq=32))
    jserver.arch, jserver.params = jcfg, jparams
    assert server.generate(prompts) == jserver.generate(prompts)
    assert len(server.step_logits) == 5


def test_zamba2_shares_one_block_over_its_sites():
    # the published 38 layers with every = 6: 6 sites, each its own KV slot,
    # and a tail of 2 Mamba2 layers; the same caches as the reference's
    for name in (ZAMBA,):
        cfg, jcfg = get_arch(name), jget_arch(name)
        caches = make_caches(cfg, 1, 8, device="cpu")
        jc = jmake_caches(jcfg, 1, 8, abstract=True)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in caches.items()} == \
            {k: (tuple(v.shape), v.dtype.name) for k, v in jc.items()}
        assert caches["k"].shape[0] == 6 and caches["ssm"].shape[0] == 38
    _, cfg = _configs(ZAMBA, **ZAMBA_TAIL)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    assert len(params["layers"]) == 5 and "attn" in params["shared_attn"]


@pytest.mark.parametrize("name", [SEAMLESS, LLAMA4, KIMI])
def test_make_caches_of_the_full_configurations_match_reference(name):
    cfg, jcfg = get_arch(name), jget_arch(name)
    caches = make_caches(cfg, 1, 8, dtype=torch.float32, device="cpu")
    jc = jmake_caches(jcfg, 1, 8, dtype=jnp.float32, abstract=True)
    assert {k: tuple(v.shape) for k, v in caches.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


# --------------------------------------------------------------------------
# seamless: the encoder, the cross cache and its quirks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seamless_bf16():
    jcfg, cfg = _configs(SEAMLESS)
    jparams, params = _carried(jcfg, cfg, fp32=False)
    return jcfg, jparams, cfg, params


def _frames(cfg, B, T, seed=8):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def test_encdec_forward_with_enc_inputs_matches_reference(seamless_bf16):
    jcfg, jparams, cfg, params = seamless_bf16
    toks, pos = _tokens(cfg, 2, 9, seed=2)
    frames = _frames(cfg, 2, 11)
    logits, _, aux = forward(params, cfg, torch.from_numpy(toks),
                             torch.from_numpy(pos),
                             enc_inputs=torch_of(frames))
    want, _, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          enc_inputs=jnp.asarray(frames))
    assert logits.shape == (2, 9, cfg.vocab_size) and float(aux) == 0.0
    assert logits.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    bf16_close(logits, want)


def test_encdec_prefill_with_enc_inputs_then_decode_match_reference(
        seamless_bf16):
    # the prefill writes the cross K/V at slot 0 (T_enc = S_max: every slot
    # written); the decode steps read them there, enc_inputs None
    jcfg, jparams, cfg, params = seamless_bf16
    B, P, T = 2, 5, 9
    toks, pos = _tokens(cfg, B, T, seed=3)
    frames = _frames(cfg, B, T)
    caches = make_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    jc = jmake_caches(jcfg, B, T, dtype=jnp.float32)
    for lo, hi in [(0, P)] + [(t, t + 1) for t in range(P, T)]:
        enc = (torch_of(frames), jnp.asarray(frames)) if lo == 0 else (None,
                                                                      None)
        lg, caches, _ = forward(params, cfg, torch.from_numpy(toks[:, lo:hi]),
                                torch.from_numpy(pos[:, lo:hi]), caches=caches,
                                cache_index=lo, enc_inputs=enc[0])
        lg0, jc, _ = jforward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]),
                              jnp.asarray(pos[:, lo:hi]), caches=jc,
                              cache_index=lo, enc_inputs=enc[1])
        bf16_close(lg, lg0)
    assert sorted(caches) == sorted(jc) == ["k", "v", "xk", "xv"]
    for key in caches:
        assert tuple(caches[key].shape) == tuple(jc[key].shape)
        bf16_close(caches[key], jc[key])


def test_encdec_cross_attention_runs_over_the_whole_cross_cache(
        seamless_bf16):
    # the reference's quirk, reproduced: with caches, cross attention runs
    # unmasked over all S_max slots, the unwritten zero ones included, so a
    # T_enc < S_max prefill gives other logits than the same forward
    # without caches (over the T_enc keys only); each equals the reference
    jcfg, jparams, cfg, params = seamless_bf16
    B, T, S, T_enc = 2, 6, 16, 5
    toks, pos = _tokens(cfg, B, T, seed=4)
    frames = _frames(cfg, B, T_enc)
    caches = make_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    cached, _, _ = forward(params, cfg, torch.from_numpy(toks),
                           torch.from_numpy(pos), caches=caches, cache_index=0,
                           enc_inputs=torch_of(frames))
    plain, _, _ = forward(params, cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), enc_inputs=torch_of(frames))
    jcached, _, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             caches=jmake_caches(jcfg, B, S, dtype=jnp.float32),
                             cache_index=0, enc_inputs=jnp.asarray(frames))
    jplain, _, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                            enc_inputs=jnp.asarray(frames))
    bf16_close(cached, jcached)
    bf16_close(plain, jplain)
    assert float((cached.float() - plain.float()).abs().max()) > 0.1
    assert not caches["xk"][:, :, T_enc:].any()   # slots past T_enc unwritten


def test_encdec_decode_reads_the_cross_cache():
    # fp32 parameters, a decode step over a cross cache half written (the
    # other half zeros): logits and caches equal the reference's
    jcfg, cfg = _configs(SEAMLESS)
    jparams, params = _carried(jcfg, cfg)
    B, S, idx = 2, 12, 7
    rng = np.random.default_rng(9)
    cache_np = {key: rng.standard_normal(
        (cfg.n_dec_layers, B, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
        for key in ("k", "v", "xk", "xv")}
    for key in ("xk", "xv"):
        cache_np[key][:, :, S // 2:] = 0.0
    toks, pos = _tokens(cfg, B, 1, seed=5)
    pos = pos + idx
    caches = {key: torch_of(a) for key, a in cache_np.items()}
    lg, caches, _ = forward(params, cfg, torch.from_numpy(toks),
                            torch.from_numpy(pos), caches=caches,
                            cache_index=idx)
    lg0, jc, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          caches={k: jnp.asarray(a) for k, a in cache_np.items()},
                          cache_index=idx)
    close(lg, lg0, LOGIT_TOL)
    for key in caches:
        close(caches[key], jc[key], LOGIT_TOL)


def test_encdec_server_generate_matches_reference():
    # Server.generate passes no enc_inputs in either package: the decoder
    # runs over a zero cross cache, and the encoder never runs
    jcfg, cfg = _configs(SEAMLESS)
    jparams, params = _carried(jcfg, cfg)
    scfg = serve.ServeConfig(arch=SEAMLESS, max_new_tokens=5, max_seq=32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 3)]
    server = serve.Server(scfg, params=params, device="cpu")
    server.arch = cfg
    jserver = jserve.Server(jserve.ServeConfig(arch=SEAMLESS, max_new_tokens=5,
                                               max_seq=32))
    jserver.arch, jserver.params = jcfg, jparams
    assert server.generate(prompts) == jserver.generate(prompts)
    assert len(server.step_logits) == 5


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def test_params_from_numpy_unstacks_every_stack():
    # kimi-k2's first layer is dense: at 3 layers, dense_layers holds 1 and
    # layers 2 (n_layers - n_dense_layers); seamless's enc and dec; Zamba2's
    # shared_attn stays one block
    cases = [(KIMI, {"n_layers": 3}, {"dense_layers": 1, "layers": 2}),
             (SEAMLESS, {"n_enc_layers": 3, "n_dec_layers": 2},
              {"enc": 3, "dec": 2}),
             (ZAMBA, ZAMBA_TAIL, {"layers": 5})]
    for name, changes, stacks in cases:
        jcfg, cfg = _configs(name, **changes)
        tree = jax.tree_util.tree_map(
            np.asarray, jinit_params(jax.random.PRNGKey(3), jcfg))
        params = params_from_numpy(tree, cfg, "cpu")
        assert sorted(params) == sorted(tree)
        for key, n in stacks.items():
            assert len(params[key]) == n, (name, key)
            for i, layer in enumerate(params[key]):
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                        tree[key]):
                    got = layer
                    for p in path:
                        got = got[p.key]
                    np.testing.assert_array_equal(
                        got.float().numpy(),
                        np.asarray(leaf[i]).astype(np.float32))
        if name == ZAMBA:
            assert isinstance(params["shared_attn"]["attn"]["wq"],
                              torch.Tensor)
    jcfg, cfg = _configs(KIMI, n_layers=3)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_params(jax.random.PRNGKey(3), jcfg))
    with pytest.raises(ValueError, match="'layers' stacks 2 layers; "
                                         "kimi-k2-1t-a32b has 3"):
        params_from_numpy(tree, dataclasses.replace(cfg, n_layers=4), "cpu")


@pytest.mark.parametrize("name", [ZAMBA, SEAMLESS, LLAMA4, KIMI])
def test_init_params_has_the_reference_tree(name):
    # the port's own random parameters: the reference's names, shapes and
    # dtypes, stack by stack
    jcfg, cfg = _configs(name)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tree = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    assert sorted(params) == sorted(tree)
    for key, spec in jax.tree_util.tree_leaves_with_path(tree):
        path = [p.key for p in key]
        leaf, stacked = params, path[0] in ("layers", "dense_layers", "enc",
                                            "dec")
        for i, p in enumerate(path):
            leaf = leaf[p]
            if i == 0 and stacked:
                assert len(leaf) == spec.shape[0], path
                leaf = leaf[0]
        shape = spec.shape[1:] if stacked else spec.shape
        assert tuple(leaf.shape) == tuple(shape), path
        assert str(leaf.dtype).removeprefix("torch.") == spec.dtype.name, path
