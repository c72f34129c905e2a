"""Remat in the port's layer loops, on the CPU.

For danube, rwkv6, llama4, zamba2 and seamless at ``scaled()`` size (fp32
carried parameters; seamless bf16, as in ``tests/test_torch_grads.py``):

  * the loss and every gradient leaf under ``full``, ``dots`` and
    ``dots_no_batch`` bit-equal to ``none`` (remat recomputes the same
    ops on the same inputs);
  * fewer bytes saved for the backward under ``full``
    (``saved_tensors_hooks`` around the forward);
  * the loss and every gradient leaf under ``full`` within
    ``test_torch_grads``'s tolerances of the reference's
    ``jax.value_and_grad``, the reference under ``jax.checkpoint`` (both
    sides get the stand-in policy ``SimpleNamespace(cs=..., remat="full")``);
  * an unknown mode raises; without grad, remat is a no-op.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import loss_fn as jloss_fn
from repro_torch.models import loss_fn
from repro_torch.optim import tree_leaves, tree_map
from test_torch_grads import (BF16_TOL, FP32_TOL, _batch, _carried,
                              _port_flat, _ref_flat, assert_peak_close)

ARCHS = ["h2o-danube-1.8b", "rwkv6-3b", "llama4-scout-17b-a16e",
         "zamba2-1.2b", "seamless-m4t-large-v2"]
MODES = ["none", "full", "dots", "dots_no_batch"]


def policy(mode):
    return types.SimpleNamespace(cs=lambda x, name: x, remat=mode)


def value_and_grad(params, cfg, batch, mode):
    """(loss, gradient leaves, bytes saved for the backward)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = loss_fn(params, cfg, {k: torch.from_numpy(v.copy())
                                         for k, v in batch.items()},
                           pol=policy(mode))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads, saved[0]


_RUNS = {}


def runs(arch):
    if arch not in _RUNS:
        jcfg, jparams, cfg, params = _carried(arch)
        batch = _batch(cfg)
        _RUNS[arch] = (jcfg, jparams, cfg, params, batch, {
            m: value_and_grad(params, cfg, batch, m) for m in MODES})
    return _RUNS[arch]


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_bits_of_no_remat(arch, mode):
    *_, out = runs(arch)
    loss0, grads0, _ = out["none"]
    loss, grads, _ = out[mode]
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        assert torch.equal(g, g0), (arch, mode, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_remat_saves_fewer_bytes(arch):
    *_, out = runs(arch)
    assert 0 < out["full"][2] < out["none"][2], (out["full"][2],
                                                 out["none"][2])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_remat_matches_the_reference_under_jax_checkpoint(arch):
    jcfg, jparams, cfg, params, batch, out = runs(arch)
    loss, grads, _ = out["full"]
    want, jgrads = jax.value_and_grad(lambda p: jloss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        pol=policy("full")))(jparams)
    bf16 = cfg.enc_dec
    np.testing.assert_allclose(float(loss), float(want),
                               rtol=1e-3 if bf16 else 1e-5)
    it = iter(grads)
    got = _port_flat(tree_map(lambda _: next(it), params))
    ref = _ref_flat(jgrads)
    assert sorted(got) == sorted(ref)
    for key, g in got.items():
        assert_peak_close(g, ref[key], BF16_TOL if bf16 else FP32_TOL, key)


def test_unknown_remat_mode_raises_and_no_grad_is_a_no_op():
    _, _, cfg, params = _carried("h2o-danube-1.8b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params, cfg, batch, pol=policy("everything"))
    with torch.no_grad():
        assert torch.equal(loss_fn(params, cfg, batch, pol=policy("full")),
                           loss_fn(params, cfg, batch))
