"""The RWKV6 scan's gradient in the port against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through ``repro`` and
``repro_torch``:

  * ``rwkv6_scan_bwd_ref`` (the plain version beside the
    ``rwkv6_scan_bwd`` kernel) against ``jax.vjp`` of the reference's
    ``rwkv6_scan_ref``, with and without an initial state and a cotangent
    on the final state, B 2, H 3, K 16, T in {1, 37, 64, 130}, V in {16,
    32}, r/k/v and dy in fp32 and in bf16;
  * the same gradients through the port's entry point ``ops.rwkv_scan``,
    whose CPU dispatch autograd differentiates, and the backward entry
    ``ops.KERNELS["rwkv6_scan_bwd"]`` on the CPU;
  * the backward kernel's algorithm written out in torch (its phases A'
    chunk adjoints, B' the carry back over the chunks, C' the row pass
    with dw in the pairwise form, C'' the value pass, D' du's sum), against
    ``rwkv6_scan_bwd_ref`` over several chunks with a ragged tail, short
    chunks and decays as strong as the model's clamp allows (w_log =
    -e**2) and stronger, within a chunk and across a chunk boundary.

Tolerances, as a fraction of each compared tensor's peak magnitude: fp32
1e-4 (fp32 sums in another order: the reference's ``lax.scan`` transpose
against a torch loop); the bf16 gradients dr, dk, dv 2 * 2**-8, two bf16
roundings of the peak (each side rounds its fp32 result once), with dw,
du and dstate, which stay fp32, at the fp32 limit.
"""

import importlib
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_ref  # noqa: E402
from _torch_cases import rwkv_inputs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")

FP32_TOL = 1e-4
BF16_TOL = 2 * 2.0 ** -8
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
CLAMP_DECAY = -math.exp(2.0)      # w_log's floor in models/layers.rwkv6_block

CASES = [(T, V, dt, with_state) for T in (1, 37, 64, 130) for V in (16, 32)
         for dt in ("float32", "bfloat16") for with_state in (False, True)]


def _inputs(T, V, dt, with_state, seed):
    """Torch fp32/bf16 tensors (B 2, H 3, K 16): r, k, v, w_log, u, state
    (or None), dy, ds_out (or None). bf16 values are exact in numpy fp32,
    so the reference sees the same numbers."""
    r, k, v, w, u, s0 = rwkv_inputs(2, 3, T, 16, V, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((2, 3, T, V)).astype(np.float32)
    ds = rng.standard_normal((2, 3, 16, V)).astype(np.float32)
    typ = getattr(torch, dt)
    r, k, v, dy = (torch.as_tensor(a).to(typ) for a in (r, k, v, dy))
    return (r, k, v, torch.as_tensor(w), torch.as_tensor(u),
            torch.as_tensor(s0) if with_state else None, dy,
            torch.as_tensor(ds) if with_state else None)


def _np(t):
    return t.float().numpy()


def _jax(t):
    a = jnp.asarray(_np(t))
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _jax_grads(r, k, v, w, u, state, dy, ds_out):
    """jax.vjp of the reference's scan: the six gradients as numpy fp32
    (dstate is None without a state)."""
    args = [_jax(x) for x in (r, k, v, w, u)]
    if state is None:
        fn = lambda *a: ref_ref.rwkv6_scan_ref(*a)  # noqa: E731
    else:
        args.append(_jax(state))
        fn = lambda *a: ref_ref.rwkv6_scan_ref(*a[:5], state=a[5])  # noqa: E731
    (y, s), vjp = jax.vjp(fn, *args)
    cot_s = jnp.zeros_like(s) if ds_out is None else _jax(ds_out)
    grads = vjp((_jax(dy).astype(y.dtype), cot_s))
    out = [np.asarray(g.astype(jnp.float32)) for g in grads]
    return out + ([None] if state is None else [])


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    peak = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * max(peak, 1e-30), (what, err, peak, err / max(peak, 1e-30))


def _tols(dt):
    low = BF16_TOL if dt == "bfloat16" else FP32_TOL
    return (low, low, low, FP32_TOL, FP32_TOL, FP32_TOL)


@pytest.mark.parametrize("T,V,dt,with_state", CASES)
def test_plain_backward_matches_jax_vjp(T, V, dt, with_state):
    inputs = _inputs(T, V, dt, with_state, seed=T * 10 + V)
    got = ref.rwkv6_scan_bwd_ref(*inputs)
    want = _jax_grads(*inputs)
    r = inputs[0]
    assert [g.dtype for g in got] == [r.dtype] * 3 + [torch.float32] * 3
    assert got[4].shape == (3, 16) and got[5].shape == (2, 3, 16, V)
    for name, g, w, tol in zip(NAMES, got, want, _tols(dt)):
        if w is not None:
            _close(g, w, tol, f"{name} T={T} V={V} {dt}")


@pytest.mark.parametrize("T,V,dt,with_state", CASES)
def test_plain_backward_matches_autograd_through_the_entry_point(T, V, dt,
                                                                 with_state):
    r, k, v, w, u, state, dy, ds_out = _inputs(T, V, dt, with_state,
                                               seed=T * 10 + V + 1)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    s_leaf = state.clone().requires_grad_() if state is not None else None
    y, s = ops.rwkv_scan(*leaves, state=s_leaf)
    cot_s = torch.zeros_like(s) if ds_out is None else ds_out
    torch.autograd.backward([y, s], [dy, cot_s])
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_out)
    got = [x.grad for x in leaves] + [s_leaf.grad if s_leaf is not None
                                      else None]
    assert [g.dtype for g in got[:5]] == [r.dtype] * 3 + [torch.float32] * 2
    for name, g, wnt, tol in zip(NAMES, got, want, _tols(dt)):
        if g is not None:
            _close(g, wnt, tol, f"{name} T={T} V={V} {dt}")
    # the backward's own entry point takes the plain version on the CPU
    direct = ops.KERNELS["rwkv6_scan_bwd"](r, k, v, w, u, state, dy, ds_out)
    for name, g, wnt in zip(NAMES, direct, want):
        assert torch.equal(g, wnt), name
    assert ops.launch_counts()["rwkv6_scan_bwd"] == 0


def _chunked_scan_bwd(r, k, v, w, u, state, dy, ds_out, C):
    """The backward kernel's phases in torch, fp32, chunks of C tokens
    (one chunk, the token passes alone, when T <= C)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    r, k, v, dy = (x.float() for x in (r, k, v, dy))
    nC = -(-T // C) if T > C else 1
    bounds = [(c * C, min(T, (c + 1) * C)) for c in range(nC)]
    zeros = torch.zeros((B, H, K, V))
    # what the forward kernel leaves: each chunk's entering state and decay
    entering, D, S = [], [], zeros if state is None else state
    for tb, te in bounds:
        entering.append(S)
        for t in range(tb, te):
            S = torch.exp(w[:, :, t])[..., None] * S \
                + k[:, :, t, :, None] * v[:, :, t, None, :]
        D.append(torch.exp(w[:, :, tb:te].sum(2)))
    G = zeros if ds_out is None else ds_out
    exits = [G]
    if nC > 1:
        M = []                                               # phase A'
        for tb, te in bounds:
            before = torch.empty_like(w[:, :, tb:te])        # P_t, a prefix sum
            acc = torch.zeros_like(w[:, :, 0])
            for t in range(te - tb):
                before[:, :, t] = acc
                acc = acc + w[:, :, tb + t]
            M.append(torch.einsum("bhtk,bhtv->bhkv",
                                  r[:, :, tb:te] * torch.exp(before),
                                  dy[:, :, tb:te]))
        exits = [None] * nC                                  # phase B'
        for c in range(nC - 1, -1, -1):
            exits[c] = G
            G = D[c][..., None] * G + M[c]
        dstate = G
    vd = (v * dy).sum(-1)
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (r, k, v, w))
    du_part = []
    for c, (tb, te) in enumerate(bounds):                    # phase C'
        S, hist = entering[c], {}
        for t in range(tb, te):
            hist[t] = S
            dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", S, dy[:, :, t]) \
                + u * k[:, :, t] * vd[:, :, t, None]
            S = torch.exp(w[:, :, t])[..., None] * S \
                + k[:, :, t, :, None] * v[:, :, t, None, :]
        G = exits[c]
        for t in range(te - 1, tb - 1, -1):
            d = torch.exp(w[:, :, t])
            dk[:, :, t] = torch.einsum("bhkv,bhv->bhk", G, v[:, :, t]) \
                + u * r[:, :, t] * vd[:, :, t, None]
            dw[:, :, t] = d * (hist[t] * G).sum(-1)          # pairwise
            G = d[..., None] * G + r[:, :, t, :, None] * dy[:, :, t, None, :]
        du_part.append((r[:, :, tb:te] * k[:, :, tb:te]
                        * vd[:, :, tb:te, None]).sum(2))
        G = exits[c]                                         # phase C''
        bonus = (r[:, :, tb:te] * u[:, None] * k[:, :, tb:te]).sum(-1)
        for t in range(te - 1, tb - 1, -1):
            dv[:, :, t] = torch.einsum("bhkv,bhk->bhv", G, k[:, :, t]) \
                + bonus[:, :, t - tb, None] * dy[:, :, t]
            G = torch.exp(w[:, :, t])[..., None] * G \
                + r[:, :, t, :, None] * dy[:, :, t, None, :]
        if nC == 1:
            dstate = G
    du = torch.zeros((H, K))                                 # phase D'
    for b in range(B):
        for part in du_part:
            du = du + part[b]
    return dr, dk, dv, dw, du, dstate


@pytest.mark.parametrize("T,C,with_state,decay", [
    (200, 64, False, None), (200, 64, True, None),    # ragged tail
    (64, 64, True, None),                             # one chunk: C' alone
    (1, 64, True, None),                              # one token
    (130, 64, True, CLAMP_DECAY),                     # the clamp's floor
    (130, 64, True, -40.0),                           # stronger still
    (130, 64, True, "boundary"),                      # the floor across c 0|1
    (45, 16, False, None), (45, 16, True, CLAMP_DECAY),   # short chunks
])
def test_chunked_backward_equals_the_recurrence(T, C, with_state, decay):
    r, k, v, w, u, s0 = (torch.as_tensor(a) for a in rwkv_inputs(
        1, 3, T, 16, 16, seed=T + C,
        decay=decay if isinstance(decay, float) else None))
    if decay == "boundary":
        w[:, :, 56:72] = CLAMP_DECAY
    rng = np.random.default_rng(T + C + 1)
    dy = torch.as_tensor(rng.standard_normal((1, 3, T, 16)).astype(np.float32))
    ds = torch.as_tensor(rng.standard_normal((1, 3, 16, 16)).astype(np.float32))
    state, ds_out = (s0, ds) if with_state else (None, None)
    got = _chunked_scan_bwd(r, k, v, w, u, state, dy, ds_out, C)
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_out)
    for name, g, wnt in zip(NAMES, got, want):
        _close(g, wnt, FP32_TOL, f"{name} T={T} C={C} decay={decay}")
    # at the floor, dw is the decay times a product of O(1) states: the
    # pairwise form keeps each entry's own precision, however small
    if decay == CLAMP_DECAY:
        np.testing.assert_allclose(got[3].numpy(), want[3].numpy(),
                                   rtol=1e-3, atol=1e-6 * math.exp(decay))


def test_forward_keeps_chunk_states_only_past_one_chunk():
    # the backward reads the forward's chunk states and decays; the chunk
    # count decides whether there are any
    assert rs.CHUNK_LEN == 64
    assert [rs.n_chunks(T) for T in (1, 64, 65, 2048, 2000)] == [1, 1, 2, 32, 32]
    x = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.rwkv6_scan_bwd(x.to("meta"), x.to("meta"), x.to("meta"),
                          x.to("meta"), torch.zeros(1, 16, device="meta"),
                          None, x.to("meta"))
