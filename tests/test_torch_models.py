"""The port's M-RoPE (qwen2-vl-72b) and MLA (minicpm3-4b) models against the
JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through ``repro`` and ``repro_torch``:

  * ``apply_rope`` with M-RoPE sections and ``default_mrope_sections``;
  * ``attention_gqa`` with M-RoPE, with and without a cache, from (B, T)
    and from (B, T, 3) positions;
  * ``attention_mla`` with and without a cache, at an MLA configuration
    whose v head dim (16) differs from its q.k head dim (16 + 8), as
    minicpm3-4b's does (64 against 64 + 32): its ``arch.scaled()`` size has
    the two equal, so the test configuration replaces them on both sides;
  * ``forward`` logits, prefill then decode equal to a full forward, the
    written caches, and ``Server.generate``, for ``qwen2-vl-72b`` and
    ``minicpm3-4b`` at ``arch.scaled()`` size and that MLA configuration,
    with the reference's parameters cast to fp32 on both sides and carried
    across by ``params_from_numpy``; and float embeddings as inputs
    (qwen2-vl's stubbed vision frontend) with the reference's bf16
    parameters on both sides;
  * the plain attention with a v head narrower than q.k's
    (``ref.flash_attention_ref``, what the CPU runs and what the card is
    held to) against the reference layer's ``sdpa``.

Tolerances: layers and logits 1e-4 in fp32 (two fp32 implementations of
the same arithmetic, sums in another order: torch's matmuls against
XLA's), as in ``test_torch_lm.py``; RoPE 1e-5 (elementwise, no sums);
attention 2e-5, the reference's own fp32 attention tolerance; bf16 logits
2**-6 (four bf16 ulps at their magnitude: bf16 rounded at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ATTN_TOL, as_reference, attention_inputs
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
ROPE_TOL = 1e-5
# minicpm3-4b's family with hdv (16) != hd (16 + 8)
MLA_WIDE_QK = dict(qk_nope_dim=16, v_head_dim=16, qk_rope_dim=8)


def torch_of(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _configs(name):
    """(reference cfg, port cfg) at smoke scale; "mla-hdv" is minicpm3-4b's
    with MLA_WIDE_QK on both sides."""
    arch = "minicpm3-4b" if name == "mla-hdv" else name
    jcfg, cfg = jget_arch(arch).scaled(), get_arch(arch).scaled()
    if name == "mla-hdv":
        jcfg = dataclasses.replace(jcfg, **MLA_WIDE_QK)
        cfg = dataclasses.replace(cfg, **MLA_WIDE_QK)
    return jcfg, as_reference(cfg, jcfg)


def _positions(B, T, start=0, streams=False, seed=0):
    """(B, T) positions from ``start``, or (B, T, 3) ones whose three
    streams differ (an image's temporal / height / width positions)."""
    pos = np.broadcast_to(np.arange(start, start + T)[None], (B, T))
    if not streams:
        return pos.astype(np.int32)
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, 7, (B, T, 2))
    return np.concatenate([pos[..., None], pos[..., None] + extra],
                          axis=-1).astype(np.int32)


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [8, 16, 64, 128, 160])
def test_default_mrope_sections_match_reference(hd):
    secs = layers.default_mrope_sections(hd)
    assert secs == jlayers.default_mrope_sections(hd)
    assert sum(secs) == hd // 2


@pytest.mark.parametrize("hd,streams", [(16, False), (16, True),
                                        (128, True), (160, True)])
def test_apply_rope_with_sections_matches_reference(hd, streams):
    B, T, H = 2, 9, 3
    x = np.random.default_rng(hd).standard_normal(
        (B, T, H, hd)).astype(np.float32)
    pos = _positions(B, T, start=5, streams=True, seed=hd)
    if not streams:   # text tokens: the three streams coincide
        pos = np.repeat(pos[..., :1], 3, axis=-1)
    secs = layers.default_mrope_sections(hd)
    got = layers.apply_rope(torch_of(x), torch.as_tensor(pos),
                            mrope_sections=secs)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              mrope_sections=secs)
    close(got, want, ROPE_TOL)
    if not streams:   # and equal to plain RoPE at the shared position
        plain = layers.apply_rope(torch_of(x), torch.as_tensor(pos[..., 0]))
        close(got, plain, ROPE_TOL)


def test_apply_rope_rejects_positions_without_the_streams():
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(x, torch.zeros(1, 4, dtype=torch.int32),
                          mrope_sections=(4, 2, 2))


# --------------------------------------------------------------------------
# the attention layers, with the reference's parameters carried across
# --------------------------------------------------------------------------

def _attention_params(name, seed=1):
    jcfg, cfg = _configs(name)
    tree = _f32(jlayers.init_attention(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("streams", [False, True])
def test_attention_gqa_mrope_matches_reference(cached, streams):
    jcfg, cfg, tree, params = _attention_params("qwen2-vl-72b")
    assert cfg.rope_kind == "mrope"
    B, T, S, idx = 2, 6, 16, 5
    x = np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = _positions(B, T, start=idx, streams=streams)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if not cached:
        y, _ = layers.attention_gqa(params, torch_of(x), cfg,
                                    torch.as_tensor(pos))
        y0, _ = jlayers.attention_gqa(jp, jnp.asarray(x), jcfg,
                                      jnp.asarray(pos))
        close(y, y0, LOGIT_TOL)
        return
    old = np.random.default_rng(3).standard_normal(
        (2, B, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    cache = {"k": torch_of(old[0]), "v": torch_of(old[1])}
    y, new = layers.attention_gqa(params, torch_of(x), cfg,
                                  torch.as_tensor(pos), cache=cache,
                                  cache_index=idx)
    y0, new0 = jlayers.attention_gqa(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
        cache={"k": jnp.asarray(old[0]), "v": jnp.asarray(old[1])},
        cache_index=idx)
    assert new is cache          # updated in place
    close(y, y0, LOGIT_TOL)
    close(new["k"], new0["k"], LOGIT_TOL)
    close(new["v"], new0["v"], LOGIT_TOL)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name", ["mla-hdv", "minicpm3-4b"])
def test_attention_mla_matches_reference(name, cached):
    jcfg, cfg, tree, params = _attention_params(name)
    assert cfg.attn_kind == "mla"
    if name == "mla-hdv":
        assert cfg.vhd != cfg.qk_nope_dim + cfg.qk_rope_dim
    assert sorted(params) == sorted(tree) == sorted(
        ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"])
    B, T, S, idx = 2, 6, 16, 5
    x = np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = _positions(B, T, start=idx)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if not cached:
        y, _ = layers.attention_mla(params, torch_of(x), cfg,
                                    torch.as_tensor(pos))
        y0, _ = jlayers.attention_mla(jp, jnp.asarray(x), jcfg,
                                      jnp.asarray(pos))
        close(y, y0, LOGIT_TOL)
        return
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.standard_normal((B, S, cfg.qk_rope_dim)).astype(np.float32)
    cache = {"lat": torch_of(lat), "rope": torch_of(rope)}
    y, new = layers.attention_mla(params, torch_of(x), cfg,
                                  torch.as_tensor(pos), cache=cache,
                                  cache_index=idx)
    y0, new0 = jlayers.attention_mla(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
        cache={"lat": jnp.asarray(lat), "rope": jnp.asarray(rope)},
        cache_index=idx)
    assert new is cache          # updated in place
    close(y, y0, LOGIT_TOL)
    close(new["lat"], new0["lat"], LOGIT_TOL)
    close(new["rope"], new0["rope"], LOGIT_TOL)


def test_attention_mla_keeps_the_reference_types():
    # bf16 weights over an fp32 latent cache: jnp promotes lat @ wkv_b to
    # fp32, so K/V are fp32 under bf16 queries, and the output is bf16
    jcfg, cfg = _configs("mla-hdv")
    params = init_params(torch.Generator().manual_seed(0), cfg)["layers"][0]
    B, T = 1, 4
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).bfloat16()
    caches = make_caches(cfg, B, 8, dtype=torch.float32, device="cpu")
    seen = {}
    orig = ops.attention

    def spy(q, k, v, **kw):
        seen.update(q=q.dtype, k=k.dtype, v=v.dtype, hd=k.shape[-1],
                    hdv=v.shape[-1], scale=kw["scale"])
        return orig(q, k, v, **kw)

    ops.attention = spy
    try:
        y, _ = layers.attention_mla(
            params["attn"], x, cfg, torch.as_tensor(_positions(B, T)),
            cache={name: c[0] for name, c in caches.items()}, cache_index=0)
    finally:
        ops.attention = orig
    assert (seen["q"], seen["k"], seen["v"]) == \
        (torch.bfloat16, torch.float32, torch.float32)
    assert (seen["hd"], seen["hdv"]) == (24, 16)
    assert seen["scale"] == pytest.approx(1 / np.sqrt(24))
    assert y.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the plain attention with a narrower v head
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,hdv,window", [
    (2, 4, 4, 6, 6, 24, 16, None),     # MLA: one KV head per query head
    (1, 8, 2, 5, 13, 96, 64, None),    # minicpm3's head dims, GQA, a tail
    (1, 4, 2, 9, 9, 32, 8, 4),         # sliding window
])
def test_flash_attention_ref_with_narrower_v_matches_reference_sdpa(
        B, H, KV, Tq, Tk, hd, hdv, window):
    q, k, _ = attention_inputs(B, H, KV, Tq, Tk, hd, seed=hd + hdv)
    v = np.random.default_rng(hdv).standard_normal(
        (B, KV, Tk, hdv)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    got = ops.attention(torch_of(q), torch_of(k), torch_of(v), window=window,
                        scale=scale)
    assert got.shape == (B, H, Tq, hdv)
    mask = jlayers._attn_mask(Tq, Tk, Tk - Tq, True, window, None)
    want = jlayers.sdpa(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v)), mask, scale=scale)
    close(got.transpose(1, 2), want, ATTN_TOL["float32"])


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen2-vl-72b", "minicpm3-4b",
                                        "mla-hdv"])
def model(request):
    """(name, reference cfg, reference fp32 params, port cfg, port params)."""
    jcfg, cfg = _configs(request.param)
    tree = _f32(jinit_params(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return request.param, jcfg, jparams, cfg, params_from_numpy(tree, cfg,
                                                                "cpu")


def _tokens(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, _positions(B, T)


def test_forward_logits_match_reference(model):
    name, jcfg, jparams, cfg, params = model
    toks, pos = _tokens(cfg, 2, 12)
    logits, _, aux = forward(params, cfg, torch.from_numpy(toks),
                             torch.from_numpy(pos))
    want, _, _ = jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    close(logits, want, LOGIT_TOL)


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "mla-hdv"])
def test_forward_takes_float_embeddings_as_inputs(name):
    # qwen2-vl's vision frontend is a stub in both packages: precomputed
    # patch embeddings (B, T, d) come in place of tokens and are cast to
    # bf16. The parameters stay bf16 here, the types the servers run in
    # (torch multiplies no bf16 activations by fp32 weights, where jnp
    # promotes), so both sides compute in bf16 and round at other places:
    # the logits (magnitude ~0.6) agree within 2**-6, four bf16 ulps
    jcfg, cfg = _configs(name)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    emb = np.random.default_rng(5).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    pos = _positions(2, 7)
    logits, _, _ = forward(params, cfg, torch_of(emb), torch.from_numpy(pos))
    want, _, _ = jforward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                          jnp.asarray(emb), jnp.asarray(pos))
    assert logits.shape == (2, 7, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(as_np(logits), as_np(want), rtol=0,
                               atol=2 ** -6)


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
    # the reference's caches have the same entries, shapes and contents
    jc = jmake_caches(jcfg, B, T, dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in caches.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    _, jc, _ = jforward(jparams, jcfg, jnp.asarray(toks.numpy()),
                        jnp.asarray(pos.numpy()), caches=jc, cache_index=0)
    for key in caches:
        close(caches[key], jc[key], LOGIT_TOL)


def test_server_generate_matches_reference(model):
    name, jcfg, jparams, cfg, params = model
    arch = "minicpm3-4b" if name == "mla-hdv" else name
    scfg = serve.ServeConfig(arch=arch, max_new_tokens=5, max_seq=32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 3)]
    server = serve.Server(scfg, params=params, device="cpu")
    server.arch = cfg
    got = server.generate(prompts)
    jserver = jserve.Server(jserve.ServeConfig(arch=arch, max_new_tokens=5,
                                               max_seq=32))
    jserver.arch, jserver.params = jcfg, jparams
    assert got == jserver.generate(prompts)
    assert len(server.step_logits) == 5


def test_params_from_numpy_carries_the_mla_tree():
    jcfg, cfg = _configs("mla-hdv")
    jcfg, cfg = (dataclasses.replace(c, n_layers=3) for c in (jcfg, cfg))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_params(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    assert len(params["layers"]) == 3
    for i, layer in enumerate(params["layers"]):
        attn = layer["attn"]
        assert sorted(attn) == sorted(tree["layers"]["attn"])
        for key, t in attn.items():
            want = np.asarray(tree["layers"]["attn"][key][i])
            assert tuple(t.shape) == want.shape, key
            assert t.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                               else torch.float32), key
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "minicpm3-4b", "mla-hdv"])
def test_init_params_has_the_reference_tree(name):
    # the port's own random parameters: the reference's names, shapes and
    # dtypes, layer by layer
    jcfg, cfg = _configs(name)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tree = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    assert len(params["layers"]) == cfg.n_layers
    for key, spec in jax.tree_util.tree_leaves_with_path(tree["layers"]):
        path = [p.key for p in key]
        leaf = params["layers"][0]
        for p in path:
            leaf = leaf[p]
        assert tuple(leaf.shape) == tuple(spec.shape[1:]), path
        assert str(leaf.dtype).removeprefix("torch.") == spec.dtype.name, path

