"""Model assembly: init, forward, prefill/decode, for every family of the
reference: ``dense`` transformers (GQA/SWA with RoPE or M-RoPE, chunked
local attention, MLA), ``rwkv6``, Mamba2 and the Zamba2 hybrid, MoE, and
encoder-decoder.

The port of ``repro.models.model``. The reference runs its layer stacks
under ``jax.lax.scan`` over stacked parameters; here each stack
(``params["layers"]``, ``"dense_layers"``, ``"enc"``, ``"dec"``) is a list
of per-layer dictionaries and the stack is a Python loop.

Caches (decode), one tensor per kind with the layer (or site) index first,
updated IN PLACE by :func:`forward` (which returns the same dictionary):
  gqa      {"k","v"}                      (L, B, S_max, KV, hd)
  mla      {"lat","rope"}                 (L, B, S_max, kvr | rdim)  (the latent)
  rwkv6    {"shift_t","shift_c","wkv"}    (L, B, d) / (L, B, H, hd, hd)
  mamba2   {"ssm"}                        (L, B, H, dn, P), fp32
  zamba2   {"ssm"} + {"k","v"}            (n_sites, B, S_max, KV, hd): one
           KV slot per application site of the ONE shared attention block
  enc-dec  {"k","v","xk","xv"}            (L_dec, B, S_max, KV, hd): the
           decoder's self K/V and the cross K/V of the encoder's output
MoE models keep the gqa (or mla) caches over all ``n_layers``: the leading
``n_dense_layers`` then the MoE layers.

MiniCPM's three scalings (``ArchConfig.scale_emb``, ``scale_depth``,
``dim_model_base``; minicpm3-4b sets them, and the reference package has
no such fields) apply where the published model applies them: the token
embedding's output times ``scale_emb``, each attention, MLP or MoE branch
of a block times ``scale_depth / sqrt(n_layers)`` before it is added to
the residual, and the final norm's output over ``d_model /
dim_model_base`` before the head. Their defaults add no operation.

Modality frontends are stubs, as in the reference: a vision model
(qwen2-vl) takes precomputed patch embeddings (B, T, d_model) as inputs
in place of tokens, and the encoder of an encoder-decoder model (seamless's
speech encoder) precomputed frame embeddings as ``enc_inputs``.

The training losses: :func:`lm_loss` (next-token cross entropy in fp32,
labels -100 masked) and :func:`loss_fn` (the forward over a batch plus
the weighted MoE aux loss), differentiated by autograd: on the card the
attention's backward is the ``flash_attention_bwd`` kernel, on the CPU
autograd through the plain attention.

Remat (the reference's ``MeshPolicy.remat``, ``jax.checkpoint`` around
each scanned layer): each layer's block of every stack runs under
``torch.utils.checkpoint`` when the policy asks for it and grad is on.
``full`` saves nothing inside the block and recomputes it in the
backward; ``dots`` saves the products (``aten.mm``/``addmm``/``bmm``/
``baddbmm``), ``dots_no_batch`` only the unbatched ``mm``/``addmm``. The
hand-written kernels are not aten products, so under every mode their
outputs are recomputed: a forward kernel launches twice a layer a step
(forward, then recompute), its backward kernel once.

Under a mesh the parameters and the batch are DTensors. Tensors the model
makes itself (masks, ``aux``, token-shift and scan states, ``arange``
positions) are plain; :func:`dtensor_region` lets DTensor treat them as
replicated.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .arch import ArchConfig
from .layers import (NULL_POLICY, apply_rope, attention_gqa, attention_mla,
                     embed, init_attention, init_embed, init_mamba2, init_mlp,
                     init_moe, init_rms, init_rwkv6, mamba2_block, mlp, moe,
                     rms_norm, rwkv6_block, split_heads, unembed)
from ..kernels import ops

__all__ = ["init_params", "make_caches", "forward", "lm_loss", "loss_fn",
           "dtensor_region", "REMAT_MODES"]

Params = Dict[str, Any]

_aten = torch.ops.aten
# the ops each remat mode saves inside a block (none under "full")
_REMAT_SAVES = {
    "full": frozenset(),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}
REMAT_MODES = ("none",) + tuple(_REMAT_SAVES)


def _remat(pol, block, *args):
    """``block(*args)`` under the policy's remat mode (with grad on)."""
    mode = getattr(pol, "remat", "none")
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r} not in {REMAT_MODES}")
    if mode == "none" or not torch.is_grad_enabled():
        return block(*args)
    saves = _REMAT_SAVES[mode]
    if not saves:
        return checkpoint(block, *args, use_reentrant=False)

    def policy(ctx, op, *a, **kw):
        return CheckpointPolicy.MUST_SAVE if op in saves \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, policy))


_regions = [0]   # dtensor regions open (in any thread: backward runs in one)


@contextlib.contextmanager
def dtensor_region(on: bool):
    """When ``on``, plain tensors meeting DTensors inside count as
    replicated DTensors: torch's ``implicit_replication()``, entered by
    the outermost region only, since it switches itself off on exit and
    regions nest (a train step's holds the forward's and the loss's, and
    remat's recompute runs in the step's backward)."""
    if not on:
        yield
        return
    _regions[0] += 1
    try:
        with implicit_replication() if _regions[0] == 1 \
                else contextlib.nullcontext():
            yield
    finally:
        _regions[0] -= 1


def _n_sites(cfg: ArchConfig) -> int:
    """Application sites of Zamba2's shared attention block."""
    return max(1, cfg.n_layers // max(1, cfg.hybrid_every))


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    if kind == "rwkv6":
        return {"rwkv": init_rwkv6(gen, cfg)}
    d, dev = cfg.d_model, gen.device
    p: Params = {"ln1": init_rms(d, device=dev)}
    if kind == "dense":
        p.update(attn=init_attention(gen, cfg), mlp=init_mlp(gen, d, cfg.d_ff),
                 ln2=init_rms(d, device=dev))
    elif kind == "moe":
        p.update(attn=init_attention(gen, cfg), moe=init_moe(gen, cfg),
                 ln2=init_rms(d, device=dev))
    elif kind == "mamba2":
        p["mamba"] = init_mamba2(gen, cfg)
    elif kind == "cross":   # decoder block: self-attn + cross-attn + mlp
        p.update(attn=init_attention(gen, cfg), cross=init_attention(gen, cfg),
                 ln_cross=init_rms(d, device=dev),
                 mlp=init_mlp(gen, d, cfg.d_ff), ln2=init_rms(d, device=dev))
    else:
        raise ValueError(kind)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on the generator's device, in
    the reference's tree with lists for its stacks: ``{"embed", "ln_f"}``
    and ``"layers"`` (dense, RWKV6, MoE); ``"dense_layers"`` before an MoE
    stack; ``"shared_attn"`` (one block) beside Zamba2's Mamba2 layers;
    ``"enc"``, ``"dec"`` and ``"ln_enc"`` for an encoder-decoder model."""
    block = lambda kind: _init_block(gen, cfg, kind)   # noqa: E731
    p: Params = {"embed": init_embed(gen, cfg),
                 "ln_f": init_rms(cfg.d_model, device=gen.device)}
    if cfg.enc_dec:
        p["enc"] = [block("dense") for _ in range(cfg.n_enc_layers)]
        p["dec"] = [block("cross") for _ in range(cfg.n_dec_layers)]
        p["ln_enc"] = init_rms(cfg.d_model, device=gen.device)
    elif cfg.ssm_kind in ("rwkv6", "mamba2"):
        p["layers"] = [block(cfg.ssm_kind) for _ in range(cfg.n_layers)]
        if cfg.ssm_kind == "mamba2" and cfg.shared_attn:
            p["shared_attn"] = block("dense")
    elif cfg.moe:
        if cfg.n_dense_layers:
            p["dense_layers"] = [block("dense")
                                 for _ in range(cfg.n_dense_layers)]
        p["layers"] = [block("moe")
                       for _ in range(cfg.n_layers - cfg.n_dense_layers)]
    else:
        p["layers"] = [block("dense") for _ in range(cfg.n_layers)]
    return p


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def make_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches on ``device``."""
    B = batch
    zeros = lambda *shape, dt=dtype: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    if cfg.enc_dec:
        L = cfg.n_dec_layers
        return {name: zeros(L, B, s_max, KV, hd)
                for name in ("k", "v", "xk", "xv")}
    if cfg.ssm_kind == "rwkv6":
        L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        hd = d // H
        return {"shift_t": zeros(L, B, d), "shift_c": zeros(L, B, d),
                "wkv": zeros(L, B, H, hd, hd, dt=torch.float32)}
    if cfg.ssm_kind == "mamba2":
        H = cfg.n_heads
        c = {"ssm": zeros(cfg.n_layers, B, H, cfg.ssm_state,
                          2 * cfg.d_model // H, dt=torch.float32)}
        if cfg.shared_attn:
            c["k"] = zeros(_n_sites(cfg), B, s_max, KV, hd)
            c["v"] = zeros(_n_sites(cfg), B, s_max, KV, hd)
        return c
    L = cfg.n_layers
    if cfg.attn_kind == "mla":
        return {"lat": zeros(L, B, s_max, cfg.kv_lora_rank),
                "rope": zeros(L, B, s_max, cfg.qk_rope_dim)}
    # absolute positions; the window masks reads (as in the reference)
    return {"k": zeros(L, B, s_max, KV, hd), "v": zeros(L, B, s_max, KV, hd)}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _layer_cache(caches, l, names=None):
    """Layer (or site) ``l``'s views of ``caches``, or None."""
    if caches is None:
        return None
    return {name: caches[name][l] for name in (names or caches)}


def _branch(y, cfg):
    """A residual branch's output as it is added: MiniCPM scales it by
    ``scale_depth / sqrt(n_layers)``."""
    if cfg.scale_depth is None:
        return y
    return y * (cfg.scale_depth / math.sqrt(cfg.n_layers))


def _attend(bp, h, cfg, positions, cache, idx, pol):
    attn_fn = attention_mla if cfg.attn_kind == "mla" else attention_gqa
    a, _ = attn_fn(bp["attn"], rms_norm(h, bp["ln1"], cfg.norm_eps),
                   cfg, positions, cache, idx, pol)
    return h + _branch(a, cfg)


def _dense_block(bp, h, cfg, positions, cache, idx, pol):
    h = _attend(bp, h, cfg, positions, cache, idx, pol)
    return h + _branch(mlp(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps),
                           cfg.act, pol), cfg)


def _moe_block(bp, h, cfg, positions, cache, idx, pol):
    h = _attend(bp, h, cfg, positions, cache, idx, pol)
    y, aux = moe(bp["moe"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg, pol)
    return h + _branch(y, cfg), aux


def _rwkv_layer(bp, h, cfg, state, pol):
    return rwkv6_block(bp["rwkv"], h, cfg, state, pol)


def _mamba_layer(bp, h, cfg, caches, l, pol):
    state = None if caches is None else caches["ssm"][l]
    y, new_state = mamba2_block(bp["mamba"], rms_norm(h, bp["ln1"],
                                                      cfg.norm_eps),
                                cfg, state, pol)
    if caches is not None:
        caches["ssm"][l].copy_(new_state)
    return h + y


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, inputs: torch.Tensor,
            positions: torch.Tensor, caches=None, cache_index=None,
            pol=NULL_POLICY, enc_inputs=None):
    """Returns (logits, caches, aux_loss).

    inputs: int tokens (B,T) (int32 or int64) or precomputed embeddings
    (B,T,d) from a stubbed modality frontend (qwen2-vl's vision patches).
    enc_inputs: an encoder-decoder model's encoder-side embeddings (B, T_enc,
    d) (seamless's stubbed speech frontend), or None at decode. With
    ``caches`` the step writes its keys/values (or recurrent state) into
    them in place at ``cache_index`` and returns the same dictionary.
    aux_loss: the MoE layers' load-balance losses summed (0 elsewhere)."""
    with dtensor_region(isinstance(inputs, DTensor)
                        or isinstance(params["embed"]["tok"], DTensor)):
        return _forward(params, cfg, inputs, positions, caches, cache_index,
                        pol, enc_inputs)


def _forward(params, cfg, inputs, positions, caches, cache_index, pol,
             enc_inputs):
    if inputs.dtype in (torch.int32, torch.int64):
        h = embed(params["embed"], inputs, pol)
        if cfg.scale_emb is not None:
            h = h * cfg.scale_emb
    else:
        h = pol.cs(inputs.to(torch.bfloat16), "act_btd")
    idx = int(cache_index) if cache_index is not None else 0
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    if cfg.enc_dec:
        h = _forward_encdec(params, cfg, h, positions, caches, idx, pol,
                            enc_inputs)
    elif cfg.ssm_kind == "mamba2":
        h = _forward_zamba(params, cfg, h, positions, caches, idx, pol)
    elif cfg.ssm_kind == "rwkv6":
        for l, bp in enumerate(params["layers"]):
            state = _layer_cache(caches, l, ("shift_t", "shift_c", "wkv"))
            h, new_state = _remat(pol, _rwkv_layer, bp, h, cfg, state, pol)
            if caches is not None:
                for name, value in new_state.items():
                    caches[name][l].copy_(value)
    elif cfg.moe:
        # the caches' leading n_dense_layers entries are the dense layers'
        nd = cfg.n_dense_layers
        for l, bp in enumerate(params.get("dense_layers", [])):
            h = _remat(pol, _dense_block, bp, h, cfg, positions,
                       _layer_cache(caches, l), idx, pol)
        for l, bp in enumerate(params["layers"]):
            h, a = _remat(pol, _moe_block, bp, h, cfg, positions,
                          _layer_cache(caches, nd + l), idx, pol)
            aux = aux + a
    else:
        for l, bp in enumerate(params["layers"]):
            h = _remat(pol, _dense_block, bp, h, cfg, positions,
                       _layer_cache(caches, l), idx, pol)
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    if cfg.dim_model_base is not None:
        h = h / (cfg.d_model / cfg.dim_model_base)
    logits = unembed(params["embed"], h, cfg, pol)
    return logits, caches, aux


def _forward_zamba(params, cfg, h, positions, caches, idx, pol):
    """Mamba2 layers; with ``shared_attn`` (Zamba2) the ONE shared dense
    block runs after every ``hybrid_every`` of them, with the same
    parameters at each site and site g's own KV cache slot, then the tail
    of ``n_layers % hybrid_every`` Mamba2 layers."""
    layers = params["layers"]
    if not cfg.shared_attn:
        for l, bp in enumerate(layers):
            h = _remat(pol, _mamba_layer, bp, h, cfg, caches, l, pol)
        return h
    every = max(1, cfg.hybrid_every)
    n_sites = _n_sites(cfg)
    for g in range(n_sites):
        for l in range(g * every, min((g + 1) * every, cfg.n_layers)):
            h = _remat(pol, _mamba_layer, layers[l], h, cfg, caches, l, pol)
        h = _remat(pol, _dense_block, params["shared_attn"], h, cfg,
                   positions, _layer_cache(caches, g, ("k", "v")), idx, pol)
    for l in range(n_sites * every, cfg.n_layers):
        h = _remat(pol, _mamba_layer, layers[l], h, cfg, caches, l, pol)
    return h


def _enc_block(bp, he, cfg, pos, pol):
    B, T, _ = he.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = rms_norm(he, bp["ln1"], cfg.norm_eps)
    q = apply_rope(split_heads(x @ bp["attn"]["wq"], B, T, H, hd), pos)
    k = apply_rope(split_heads(x @ bp["attn"]["wk"], B, T, KV, hd), pos)
    v = split_heads(x @ bp["attn"]["wv"], B, T, KV, hd)
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False)
    he = he + out.transpose(1, 2).reshape(B, T, H * hd) @ bp["attn"]["wo"]
    return he + mlp(bp["mlp"], rms_norm(he, bp["ln2"], cfg.norm_eps),
                    cfg.act, pol)


def _encode(params, cfg, enc_inputs, pol):
    """The bidirectional encoder over the frame embeddings: RoPE at
    positions 0..T_enc-1, attention with no mask, window or chunk."""
    he = pol.cs(enc_inputs.to(torch.bfloat16), "act_btd")
    B, T, _ = he.shape
    pos = torch.arange(T, device=he.device)[None].expand(B, T)
    for bp in params["enc"]:
        he = _remat(pol, _enc_block, bp, he, cfg, pos, pol)
    return rms_norm(he, params["ln_enc"], cfg.norm_eps)


def _forward_encdec(params, cfg, h, positions, caches, idx, pol, enc_inputs):
    """Encoder-decoder (seamless): the encoder over ``enc_inputs``, then the
    causal decoder, each block self-attention, cross attention over the
    encoder's output, MLP.

    At a prefill with ``enc_inputs`` and caches, each layer's cross K/V are
    written into ``xk``/``xv`` at slot 0; a decode step (``enc_inputs``
    None) reads them there. As in the reference (``model.py:395-404``),
    cross attention with caches runs unmasked over the WHOLE S_max-long
    cross cache, unwritten zero slots included; without caches over the
    T_enc encoder outputs only. A decode with no encoder run before it
    (``Server.generate`` passes no ``enc_inputs``) attends over a zero
    cross cache."""
    enc_out = None if enc_inputs is None else _encode(params, cfg,
                                                      enc_inputs, pol)
    for l, bp in enumerate(params["dec"]):
        h = _remat(pol, _dec_block, bp, h, cfg, positions, caches, l, idx,
                   pol, enc_out)
    return h


def _dec_block(bp, h, cfg, positions, caches, l, idx, pol, enc_out):
    B, T, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _attend(bp, h, cfg, positions, _layer_cache(caches, l, ("k", "v")),
                idx, pol)
    x = rms_norm(h, bp["ln_cross"], cfg.norm_eps)
    q = split_heads(x @ bp["cross"]["wq"], B, T, H, hd)
    if enc_out is not None:
        Te = enc_out.shape[1]
        xk = split_heads(enc_out @ bp["cross"]["wk"], B, Te, KV, hd)
        xv = split_heads(enc_out @ bp["cross"]["wv"], B, Te, KV, hd)
        if caches is not None:
            caches["xk"][l, :, :Te].copy_(xk)
            caches["xv"][l, :, :Te].copy_(xv)
            xk, xv = caches["xk"][l], caches["xv"][l]
    else:
        xk, xv = caches["xk"][l], caches["xv"][l]
    out = ops.attention(q.transpose(1, 2), xk.transpose(1, 2),
                        xv.transpose(1, 2), causal=False)
    h = h + out.transpose(1, 2).reshape(B, T, H * hd) @ bp["cross"]["wo"]
    return h + mlp(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg.act,
                   pol)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            pol=NULL_POLICY) -> torch.Tensor:
    """Next-token cross entropy in fp32; labels -100 are masked."""
    with dtensor_region(isinstance(logits, DTensor)):
        return _lm_loss(logits, labels)


def _lm_loss(logits, labels):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    idx = labels.clamp_min(0).long()[..., None]
    gold = _gold_shards(lf, idx) if isinstance(lf, DTensor) \
        else torch.gather(lf, -1, idx)[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _gold_shards(lf: DTensor, idx) -> DTensor:
    """``gather(lf, -1, idx)[..., 0]`` over logits sharded on the vocabulary:
    each rank picks the labels its columns hold and zeroes the others, a
    partial sum with one nonzero term (exact), then reduced. (DTensor's own
    masked gather loses its mask on the squeeze, or when the labels are
    sharded otherwise than the logits.)"""
    mesh = lf.device_mesh
    lf = lf.redistribute(mesh, [Replicate() if p.is_partial() else p
                                for p in lf.placements])
    pl = lf.placements
    start = ops.shard_start(lf, 2)
    row_pl = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate()
                   for p in pl)

    def pick(lf_local, idx):
        j = idx - start
        hit = (j >= 0) & (j < lf_local.shape[-1])
        g = torch.gather(lf_local, -1, j.clamp(0, lf_local.shape[-1] - 1))
        return (g * hit.to(g.dtype))[..., 0]
    out_pl = tuple(Partial() if p.is_shard(2) else q
                   for p, q in zip(pl, row_pl))
    gold = local_map(pick, out_placements=(out_pl,),
                     in_placements=(tuple(pl), row_pl), device_mesh=mesh,
                     redistribute_inputs=True)(lf, idx)
    return gold.redistribute(mesh, row_pl)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            pol=NULL_POLICY, aux_weight: float = 0.01) -> torch.Tensor:
    """The batch's loss: ``embeds`` (a stubbed frontend's) or ``tokens``,
    ``positions`` (0..T-1 by default), ``enc_embeds`` for an
    encoder-decoder model, ``labels``; plus ``aux_weight`` times the MoE
    aux loss."""
    inputs = batch.get("embeds", batch.get("tokens"))
    positions = batch.get("positions")
    if positions is None:
        B, T = inputs.shape[:2]
        positions = torch.arange(T, device=inputs.device)[None].expand(B, T)
    logits, _, aux = forward(params, cfg, inputs, positions, pol=pol,
                             enc_inputs=batch.get("enc_embeds"))
    return lm_loss(logits, batch["labels"], pol) + aux_weight * aux
