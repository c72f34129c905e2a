"""The port's LM serving slice against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through ``repro`` and ``repro_torch``:

  * ``ops.attention`` / ``ops.rwkv_scan`` (their plain torch versions on the
    CPU) against the reference's oracles over the reference's sweeps, and
    against the Pallas kernels in interpret mode on small cases;
  * ``decay_linear_attention``, ``attention_gqa`` and ``rwkv6_block``, with
    and without a cache;
  * ``forward`` logits, prefill-then-decode, the sliding window, and
    ``Server.generate`` for ``h2o-danube-1.8b`` and ``rwkv6-3b`` at
    ``arch.scaled()`` size, with the reference's parameters cast to fp32 on
    both sides and carried across by ``params_from_numpy``.

Tolerances: the reference's own kernel tolerances (attention 2e-5 fp32 /
2e-2 bf16, scan 1e-3 / 3e-2); layers and logits 1e-4 in fp32 (two fp32
implementations of the same arithmetic, sums in another order: the
sequential scan against the reference's chunked one, torch's matmuls
against XLA's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (ATTN_EXTRA, ATTN_SWEEP, ATTN_TOL, RWKV_SWEEP,
                          RWKV_TOL, TORCH_DTYPES, as_reference,
                          attention_inputs, rwkv_inputs)
from repro.kernels import flash_attention as pallas_flash_attention
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as pallas_rwkv6_scan
from repro.launch import serve as jserve
from repro.models import forward as jforward
from repro.models import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import make_caches as jmake_caches
from repro_torch.carry import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import forward, get_arch, init_params, make_caches
from repro_torch.models import layers

LOGIT_TOL = 1e-4
ARCHS = ["h2o-danube-1.8b", "rwkv6-3b"]


def jnp_of(a, dtype="float32"):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


def torch_of(a, dtype="float32"):
    return torch.as_tensor(np.asarray(a)).to(TORCH_DTYPES[dtype])


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# the kernels' plain versions
# --------------------------------------------------------------------------

def test_sweeps_mirror_the_reference_kernel_tests():
    import test_kernels
    names = {jnp.float32: "float32", jnp.bfloat16: "bfloat16"}
    assert [c[:6] + (names[c[6]],) + c[7:] for c in test_kernels.ATTN_SWEEP] \
        == ATTN_SWEEP
    assert [c[:6] + (names[c[6]],) for c in test_kernels.RWKV_SWEEP] \
        == RWKV_SWEEP


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,dt,causal,window,chunk",
                         ATTN_SWEEP + ATTN_EXTRA)
def test_attention_matches_reference_oracle(B, H, KV, Tq, Tk, hd, dt, causal,
                                            window, chunk):
    q, k, v = attention_inputs(B, H, KV, Tq, Tk, hd, seed=Tq + Tk + hd)
    got = ops.attention(torch_of(q, dt), torch_of(k, dt), torch_of(v, dt),
                        causal=causal, window=window, chunk=chunk)
    want = jref.flash_attention_ref(jnp_of(q, dt), jnp_of(k, dt),
                                    jnp_of(v, dt), causal=causal,
                                    window=window, chunk=chunk)
    assert got.dtype == TORCH_DTYPES[dt] and got.shape == (B, H, Tq, hd)
    close(got, want, ATTN_TOL[dt])


def test_plain_sdpa_with_the_layer_mask_equals_the_kernel_route():
    # the reference layer's route (sdpa over the full mask) and the port's
    # (ops.attention, queries at the tail of the keys)
    q, k, v = attention_inputs(2, 8, 2, 6, 6, 16, seed=8)
    q, k, v = (torch_of(a).transpose(1, 2) for a in (q, k, v))
    mask = layers._attn_mask(6, 6, 0, True, 3, None)
    want = layers.sdpa(q, k, v, mask)
    got = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), window=3)
    close(got.transpose(1, 2), want, ATTN_TOL["float32"])


@pytest.mark.parametrize("window,chunk", [(16, None), (None, 32)])
def test_attention_matches_pallas_interpret(window, chunk):
    q, k, v = attention_inputs(1, 4, 2, 32, 64, 16, seed=5)
    got = ops.attention(torch_of(q), torch_of(k), torch_of(v), window=window,
                        chunk=chunk)
    want = pallas_flash_attention(jnp_of(q), jnp_of(k), jnp_of(v),
                                  window=window, chunk=chunk, block_q=32,
                                  block_k=32, interpret=True)
    close(got, want, ATTN_TOL["float32"])


def test_attention_fully_masked_rows_give_zero():
    # window 1 with the queries past every key: no key is visible
    q, k, v = attention_inputs(1, 2, 2, 4, 4, 16, seed=3)
    got = ops.attention(torch_of(q), torch_of(k), torch_of(v), causal=True,
                        chunk=2)
    want = jref.flash_attention_ref(jnp_of(q), jnp_of(k), jnp_of(v),
                                    causal=True, chunk=2)
    close(got, want, ATTN_TOL["float32"])
    empty = ops.attention(torch_of(q), torch_of(k)[:, :, :0],
                          torch_of(v)[:, :, :0])
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,H,T,K,V,chunk,dt", RWKV_SWEEP)
def test_rwkv_scan_matches_reference_oracle(B, H, T, K, V, chunk, dt,
                                            with_state):
    r, k, v, w, u, s0 = rwkv_inputs(B, H, T, K, V, seed=T + K)
    state = s0 if with_state else None
    y, s = ops.rwkv_scan(torch_of(r, dt), torch_of(k, dt), torch_of(v, dt),
                         torch_of(w), torch_of(u),
                         state=None if state is None else torch_of(state))
    y0, s_ref = jref.rwkv6_scan_ref(jnp_of(r, dt), jnp_of(k, dt),
                                    jnp_of(v, dt), jnp_of(w), jnp_of(u),
                                    state=None if state is None
                                    else jnp_of(state))
    assert y.dtype == TORCH_DTYPES[dt] and s.dtype == torch.float32
    close(y, y0, RWKV_TOL[dt])
    close(s, s_ref, 1e-3)


def test_rwkv_scan_matches_pallas_interpret():
    r, k, v, w, u, _ = rwkv_inputs(1, 2, 32, 16, 16, seed=9)
    y, s = ops.rwkv_scan(*(torch_of(a) for a in (r, k, v, w, u)))
    y0, s0 = pallas_rwkv6_scan(*(jnp_of(a) for a in (r, k, v, w, u)),
                               chunk=16, interpret=True)
    close(y, y0, RWKV_TOL["float32"])
    close(s, s0, 1e-3)


def test_rwkv_scan_decodes_one_token_from_a_state():
    # T = 1 from a nonzero state == the last step of the full sequence
    r, k, v, w, u, _ = rwkv_inputs(1, 2, 9, 16, 16, seed=4)
    full_y, full_s = ops.rwkv_scan(*(torch_of(a) for a in (r, k, v, w, u)))
    _, s8 = ops.rwkv_scan(*(torch_of(a[:, :, :8]) for a in (r, k, v, w)),
                          torch_of(u))
    y9, s9 = ops.rwkv_scan(*(torch_of(a[:, :, 8:]) for a in (r, k, v, w)),
                           torch_of(u), state=s8)
    close(y9, full_y[:, :, 8:], 1e-5)
    close(s9, full_s, 1e-5)


def test_rwkv_scan_extreme_decay_stays_finite():
    r, k, v, w, u, _ = rwkv_inputs(1, 1, 64, 16, 16, seed=1, decay=-40.0)
    y, s = ops.rwkv_scan(*(torch_of(a) for a in (r, k, v, w)),
                         torch.zeros(1, 16))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("T,with_state", [(64, False), (45, True)])
def test_decay_linear_attention_matches_reference(T, with_state):
    r, k, v, w, u, s0 = rwkv_inputs(2, 2, T, 16, 16, seed=T)
    state = s0 if with_state else None
    y, s = layers.decay_linear_attention(
        *(torch_of(a) for a in (r, k, v, w)), u=torch_of(u),
        state=None if state is None else torch_of(state))
    y0, s_ref = jlayers.decay_linear_attention(
        *(jnp_of(a) for a in (r, k, v, w)), u=jnp_of(u),
        state=None if state is None else jnp_of(state))
    # fp32 sums of a 64-step recurrence in another order: the reference's
    # own scan tolerance, here and for the sequential scan below
    close(y, y0, RWKV_TOL["float32"])
    close(s, s_ref, RWKV_TOL["float32"])
    # and the scan the port's layers run computes the same function
    y1, s1 = ops.rwkv_scan(*(torch_of(a) for a in (r, k, v, w)), torch_of(u),
                           state=None if state is None else torch_of(state))
    close(y1, y, RWKV_TOL["float32"])
    close(s1, s, RWKV_TOL["float32"])


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu"])
def test_activations_match_reference(kind):
    # jax.nn.gelu is the tanh approximation; the port's act_fn must be too
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(layers.act_fn(kind)(torch_of(x)), jlayers.act_fn(kind)(jnp_of(x)),
          1e-6)


# --------------------------------------------------------------------------
# layers and models, with the reference's parameters carried across
# --------------------------------------------------------------------------

def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(name, reference cfg, reference fp32 params, port cfg, port params)."""
    name = request.param
    jcfg = jget_arch(name).scaled()
    cfg = as_reference(get_arch(name).scaled(), jcfg)
    tree = _f32(jinit_params(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return name, jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu")


def _tokens(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    return toks, pos


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.mark.parametrize("cached", [False, True])
def test_attention_gqa_matches_reference(cached):
    jcfg = jget_arch("h2o-danube-1.8b").scaled()
    cfg = get_arch("h2o-danube-1.8b").scaled()
    tree = _f32(jlayers.init_attention(jax.random.PRNGKey(1), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    B, T, S, idx = 2, 6, 16, 5
    x = np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(idx, idx + T)[None], (B, T)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if not cached:
        y, _ = layers.attention_gqa(params, torch_of(x), cfg, torch_of(pos))
        y0, _ = jlayers.attention_gqa(jp, jnp_of(x), jcfg, jnp.asarray(pos))
        close(y, y0, LOGIT_TOL)
        return
    # a cache holding earlier entries, written at idx
    old = np.random.default_rng(3).standard_normal(
        (2, B, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    cache = {"k": torch_of(old[0]), "v": torch_of(old[1])}
    y, new = layers.attention_gqa(params, torch_of(x), cfg, torch_of(pos),
                                  cache=cache, cache_index=idx)
    y0, new0 = jlayers.attention_gqa(
        jp, jnp_of(x), jcfg, jnp.asarray(pos),
        cache={"k": jnp_of(old[0]), "v": jnp_of(old[1])}, cache_index=idx)
    assert new is cache          # updated in place
    close(y, y0, LOGIT_TOL)
    close(new["k"], new0["k"], LOGIT_TOL)
    close(new["v"], new0["v"], LOGIT_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_rwkv6_block_matches_reference(cached):
    jcfg = jget_arch("rwkv6-3b").scaled()
    cfg = get_arch("rwkv6-3b").scaled()
    tree = _f32(jlayers.init_rwkv6(jax.random.PRNGKey(1), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    B, T, d, H = 2, 7, cfg.d_model, cfg.n_heads
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    state = jstate = None
    if cached:
        st = {"shift_t": rng.standard_normal((B, d)),
              "shift_c": rng.standard_normal((B, d)),
              "wkv": rng.standard_normal((B, H, d // H, d // H))}
        state = {k: torch_of(v) for k, v in st.items()}
        jstate = {k: jnp_of(v) for k, v in st.items()}
    y, new = layers.rwkv6_block(params, torch_of(x), cfg, state)
    y0, new0 = jlayers.rwkv6_block(jp, jnp_of(x), jcfg, jstate)
    close(y, y0, LOGIT_TOL)
    for key in ("shift_t", "shift_c", "wkv"):
        close(new[key], new0[key], LOGIT_TOL)


def test_forward_logits_match_reference(model):
    name, jcfg, jparams, cfg, params = model
    toks, pos = _tokens(cfg, 2, 12)
    logits, _, aux = forward(params, cfg, torch.from_numpy(toks),
                             torch.from_numpy(pos))
    want, _, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    close(logits, want, LOGIT_TOL)
    # int64 tokens take the embedding path too
    logits64, _, _ = forward(params, cfg, torch.from_numpy(toks).long(),
                             torch.from_numpy(pos))
    assert torch.equal(logits64, logits)


def test_prefill_then_decode_matches_full_forward(model):
    name, jcfg, jparams, cfg, params = model
    B, P, T = 2, 5, 9
    toks, pos = _tokens(cfg, B, T, seed=1)
    toks, pos = torch.from_numpy(toks), torch.from_numpy(pos)
    full, _, _ = forward(params, cfg, toks, pos)
    caches = make_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    logits, caches, _ = forward(params, cfg, toks[:, :P], pos[:, :P],
                                caches=caches, cache_index=0)
    steps = [logits]
    for t in range(P, T):
        lg, caches, _ = forward(params, cfg, toks[:, t:t + 1],
                                pos[:, t:t + 1], caches=caches, cache_index=t)
        steps.append(lg)
    close(torch.cat(steps, dim=1), full, LOGIT_TOL)
    # the reference's decode step writes the same cache
    jc = jmake_caches(jcfg, B, T, dtype=jnp.float32)
    _, jc, _ = jforward(jparams, jcfg, jnp.asarray(toks.numpy()),
                        jnp.asarray(pos.numpy()), caches=jc, cache_index=0)
    for key in caches:
        close(caches[key], jc[key], LOGIT_TOL)


def test_sliding_window_masks_old_tokens():
    cfg = dataclasses.replace(get_arch("h2o-danube-1.8b").scaled(), window=4)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    params = jax.tree_util.tree_map(lambda t: t.float(), params)
    toks, pos = _tokens(cfg, 1, 12, seed=2)
    toks, pos = torch.from_numpy(toks), torch.from_numpy(pos)
    l1, _, _ = forward(params, cfg, toks, pos)
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
    l2, _, _ = forward(params, cfg, toks2, pos)
    close(l1[0, -1], l2[0, -1], 1e-5)
    assert not torch.allclose(l1[0, 2], l2[0, 2])   # inside the window


def test_server_generate_matches_reference(model):
    name, jcfg, jparams, cfg, params = model
    scfg = serve.ServeConfig(arch=name, max_new_tokens=5, max_seq=32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 3)]
    server = serve.Server(scfg, params=params, device="cpu")
    got = server.generate(prompts)
    jserver = jserve.Server(jserve.ServeConfig(arch=name, max_new_tokens=5,
                                               max_seq=32))
    jserver.params = jparams
    assert got == jserver.generate(prompts)
    assert len(server.step_logits) == 5
    assert server.timing["decode_steps"] == 4


def test_server_draws_its_own_parameters_from_the_seed():
    scfg = serve.ServeConfig(arch="rwkv6-3b", max_new_tokens=3, max_seq=16)
    a = serve.Server(scfg, device="cpu")
    b = serve.Server(scfg, device="cpu")
    prompts = [np.arange(4, dtype=np.int32)]
    assert a.generate(prompts) == b.generate(prompts)
    w = a.params["layers"][0]["rwkv"]
    assert w["wr"].dtype == torch.bfloat16 and w["u"].dtype == torch.float32


def test_server_main_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-3b", "--device", "cpu", "--requests", "2",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert '"requests": 2' in out and '"device": "cpu"' in out


def test_params_from_numpy_keeps_bf16_bits():
    jcfg = jget_arch("rwkv6-3b").scaled(n_layers=1)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_params(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(tree, get_arch("rwkv6-3b").scaled(n_layers=1),
                               "cpu")
    wr = params["layers"][0]["rwkv"]["wr"]
    assert wr.dtype == torch.bfloat16
    np.testing.assert_array_equal(wr.float().numpy(),
                                  np.asarray(tree["layers"]["rwkv"]["wr"][0],
                                             np.float32))
    assert params["layers"][0]["rwkv"]["u"].dtype == torch.float32


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_families_not_ported_yet_raise(name):
    # these families raised NotImplementedError until the port served them
    # (their parity with the reference: test_torch_families.py); now every
    # registered family runs, and no family raises
    cfg = get_arch(name).scaled()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks, pos = _tokens(cfg, 1, 4)
    enc = torch.randn(1, 3, cfg.d_model) if cfg.enc_dec else None
    logits, _, aux = forward(params, cfg, torch.from_numpy(toks),
                             torch.from_numpy(pos), enc_inputs=enc)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert aux.shape == ()
