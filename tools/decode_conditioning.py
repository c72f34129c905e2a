#!/usr/bin/env python3
"""How well conditioned a model's logits are, on the CPU: cached decode
against a full forward, and the growth of a small perturbation layer by
layer.

    PYTHONPATH=src python3 tools/decode_conditioning.py --package repro_torch
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/decode_conditioning.py \\
        --package repro

At the published width of ``--arch`` (zamba2-1.2b by default) with
``--layers`` layers and seeded random weights, one request: a prefill of
``--prompt`` tokens into the caches, then ``--steps`` decode steps fed fixed
random tokens, against one forward of all the tokens without caches. Prints
one JSON line per weight type (bf16 as drawn, and cast to fp32) with each
step's largest absolute logit difference and the peak logit. With
``--package repro_torch`` and a Mamba2 model it also prints the relative
difference of the hidden state after each layer between two fp32 forwards
whose embeddings differ by a relative 1e-6 (``growth``).

Imports only the package it is asked for: JAX for ``repro``, torch for
``repro_torch``. Each package draws its own weights from the seed.
"""

import argparse
import dataclasses
import json

import numpy as np


def _torch_run(arch, params, toks, P):
    import torch
    from repro_torch.models import forward, make_caches
    toks = torch.as_tensor(toks)
    pos = torch.arange(toks.shape[1], dtype=torch.int32)[None]
    with torch.no_grad():
        full, _, _ = forward(params, arch, toks, pos)
        caches = make_caches(arch, 1, toks.shape[1], dtype=torch.float32,
                             device="cpu")
        lg, _, _ = forward(params, arch, toks[:, :P], pos[:, :P],
                           caches=caches, cache_index=0)
        steps = [lg[0, -1]]
        for t in range(P, toks.shape[1] - 1):
            lg, _, _ = forward(params, arch, toks[:, t:t + 1],
                               pos[:, t:t + 1], caches=caches, cache_index=t)
            steps.append(lg[0, -1])
    return (torch.stack(steps).float().numpy(),
            full[0, P - 1:-1].float().numpy())


def _jax_run(arch, params, toks, P):
    import jax.numpy as jnp
    from repro.models import forward, make_caches
    toks = jnp.asarray(toks)
    pos = jnp.arange(toks.shape[1], dtype=jnp.int32)[None]
    full, _, _ = forward(params, arch, toks, pos)
    caches = make_caches(arch, 1, toks.shape[1], dtype=jnp.float32)
    lg, caches, _ = forward(params, arch, toks[:, :P], pos[:, :P],
                            caches=caches, cache_index=0)
    steps = [lg[0, -1]]
    for t in range(P, toks.shape[1] - 1):
        lg, caches, _ = forward(params, arch, toks[:, t:t + 1],
                                pos[:, t:t + 1], caches=caches, cache_index=t)
        steps.append(lg[0, -1])
    return (np.asarray(jnp.stack(steps), np.float32),
            np.asarray(full[0, P - 1:-1], np.float32))


def _torch_growth(arch, params, toks):
    """Relative hidden-state difference after each Mamba2 layer (and the
    shared block after it, where it runs) of two fp32 forwards."""
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import embed
    pos = torch.arange(toks.shape[1], dtype=torch.int32)[None]
    h0 = embed(params["embed"], torch.as_tensor(toks))
    gen = torch.Generator().manual_seed(1)
    h1 = h0 * (1 + 1e-6 * torch.randn(h0.shape, generator=gen))
    every, out = max(1, arch.hybrid_every), []
    with torch.no_grad():
        for l, bp in enumerate(params["layers"]):
            h0, h1 = (model._mamba_layer(bp, h, arch, None, l, None)
                      for h in (h0, h1))
            if arch.shared_attn and (l + 1) % every == 0 \
                    and (l + 1) // every <= model._n_sites(arch):
                h0, h1 = (model._dense_block(params["shared_attn"], h, arch,
                                             pos, None, 0, None)
                          for h in (h0, h1))
            out.append(float((h1 - h0).norm() / h0.norm()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    required=True)
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.package == "repro":
        import jax
        import jax.numpy as jnp
        from repro.models import get_arch, init_params
        arch = get_arch(args.arch)
        arch = dataclasses.replace(arch, n_layers=args.layers or arch.n_layers)
        drawn = init_params(jax.random.PRNGKey(args.seed), arch)
        cast = lambda p: jax.tree_util.tree_map(   # noqa: E731
            lambda a: a.astype(jnp.float32), p)
        run = _jax_run
    else:
        import torch
        from repro_torch.models import get_arch, init_params
        arch = get_arch(args.arch)
        arch = dataclasses.replace(arch, n_layers=args.layers or arch.n_layers)
        drawn = init_params(torch.Generator().manual_seed(args.seed), arch)

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v) for v in tree]
            return tree.float()
        run = _torch_run
    toks = np.random.default_rng(args.seed).integers(
        0, arch.vocab_size, (1, args.prompt + args.steps)).astype(np.int32)
    for dtype, params in (("bfloat16", drawn), ("float32", cast(drawn))):
        served, full = run(arch, params, toks, args.prompt)
        print(json.dumps({
            "package": args.package, "arch": arch.name,
            "layers": arch.n_layers, "prompt": args.prompt,
            "weights": dtype, "logit_peak": float(np.abs(full).max()),
            "decode_vs_full_forward_max_abs_err_by_step":
                np.abs(served - full).max(-1).tolist()}), flush=True)
    if args.package == "repro_torch" and arch.ssm_kind == "mamba2":
        print(json.dumps({"package": args.package, "arch": arch.name,
                          "growth": _torch_growth(arch, cast(drawn),
                                                  toks[:, :200])}),
              flush=True)


if __name__ == "__main__":
    main()
