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
  * the backward kernel's CUDA-core body written out in torch (its phases
    A' chunk adjoints, B' the carry back over the chunks, C' the row pass
    with dw in the pairwise form, C'' the value pass, D' du's sum), against
    ``rwkv6_scan_bwd_ref`` over several chunks with a ragged tail, short
    chunks and decays as strong as the model's clamp allows (w_log =
    -e**2) and stronger, within a chunk and across a chunk boundary;
  * its tensor-core body written out in torch (``_chunked_matrix_scan_bwd``:
    each chunk's gradients as products over sub-chunks of 16 tokens, the
    tensor cores' bf16 operand rounding and bf16 hi + lo splits emulated,
    dw as sums of paths through w_t), against ``rwkv6_scan_bwd_ref`` and
    an fp64 token recurrence, over several chunks with a ragged tail, one
    chunk, T 37, 16 and 1, a state and final-state cotangent, and the
    floor -e**2 everywhere, across a chunk boundary and across a
    sub-chunk boundary;
  * ``rwkv6_scan.scan_bwd_body``, the choice between the two bodies, at
    every shape of ``_torch_cases.SCAN_BWD_CASES`` (the on-card tests'
    cases of the backward kernel) and over a grid.

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
from _torch_cases import SCAN_BWD_CASES, rwkv_inputs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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


# ---------------------------------------------------------------------------
# the tensor-core ("mma") body

SUB = 16                  # tokens per sub-chunk


def _bf(x):
    """The tensor cores' bf16 operand rounding."""
    return x.to(torch.bfloat16).float()


def _split(x):
    """fp32 as bf16 hi + lo."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def _mm3(a, b):
    """a @ b with both split into bf16 hi + lo, less lo @ lo (the tensor
    cores' product of fp32 operands, to about 2**-16 of each term)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _before(x):
    """sum_{s < t} x_s over dim 2, nothing subtracted."""
    return F.pad(torch.cumsum(x, 2)[:, :, :-1], (0, 0, 1, 0))


def _after(x):
    """sum_{tau > t} x_tau over dim 2, nothing subtracted."""
    return _before(x.flip(2)).flip(2)


def _chunk_ends(r, k, v, w, state, dy, ds_out, C):
    """What the forward kernel and phases A' and B' leave: each chunk's
    token range, the state entering it, the cotangent of the state leaving
    it, and dstate."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    nC = -(-T // C) if T > C else 1
    bounds = [(c * C, min(T, (c + 1) * C)) for c in range(nC)]
    zeros = torch.zeros((B, H, K, V))
    entering, D, S = [], [], zeros if state is None else state
    for tb, te in bounds:
        entering.append(S)
        for t in range(tb, te):
            S = torch.exp(w[:, :, t])[..., None] * S \
                + k[:, :, t, :, None] * v[:, :, t, None, :]
        D.append(torch.exp(w[:, :, tb:te].sum(2)))
    G = zeros if ds_out is None else ds_out
    exits = [None] * nC
    for c in range(nC - 1, -1, -1):
        tb, te = bounds[c]
        exits[c] = G
        before = torch.cumsum(w[:, :, tb:te], 2) - w[:, :, tb:te]
        M = torch.einsum("bhtk,bhtv->bhkv", r[:, :, tb:te] * torch.exp(before),
                         dy[:, :, tb:te])
        G = D[c][..., None] * G + M
    return bounds, entering, exits, G


def _chunked_matrix_scan_bwd(r, k, v, w, u, state, dy, ds_out, C=64):
    """The backward kernel's tensor-core body in torch, chunks of C tokens
    as four sub-chunks of 16. Per chunk, with A the sum of w (kept as sums
    within a sub-chunk plus whole sub-chunks' sums) and Q = dY V^T:
    Q, X1 = L dY, X2 = G V and X3 = (K e^{A_C - A}) G (L, G and the
    decayed K split into bf16 hi + lo); the tables K3(i) = k e^{A(start of
    i) - A} and R3(i) = r e^{A_{t-1} - A(start of i)}; per sub-chunk m, X =
    sum_{j<m} Q[m, j] K3(m)_j and Y = sum_{i>m} Q[i, m]^T R3(m+1)_i (split),
    P^T's off-diagonal tiles in bf16 and P^T dY; the diagonal tiles pair by
    pair; dw_t as the tile's straddle, alpha = a + N's row sums after t and
    beta = b + N's column sums before t within t's sub-chunk, T_M (N over s
    before the sub-chunk and tau after it), and a and b summed over whole
    sub-chunks."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    r, k, v, dy = (x.float() for x in (r, k, v, dy))
    bounds, entering, exits, dstate = _chunk_ends(r, k, v, w, state, dy,
                                                  ds_out, C)
    nb = C // SUB
    blk = lambda m: slice(m * SUB, (m + 1) * SUB)  # noqa: E731
    tri = torch.tril(torch.ones(SUB, SUB), -1)     # [tau, s]: s < tau
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (r, k, v, w))
    du = torch.zeros((H, K))
    for c, (tb, te) in enumerate(bounds):
        n = te - tb
        pad = lambda x: F.pad(x[:, :, tb:te], (0, 0, 0, C - n))  # noqa: E731
        rc, kc, vc, dyc, wc = (pad(x) for x in (r, k, v, dy, w))
        L, G = entering[c], exits[c]
        Al = torch.cat([torch.cumsum(wc[:, :, blk(m)], 2) for m in range(nb)],
                       2)                           # to t, within t's sub-chunk
        Ae = torch.cat([F.pad(Al[:, :, blk(m)][:, :, :-1], (0, 0, 1, 0))
                        for m in range(nb)], 2)     # before t, within it
        tot = [Al[:, :, m * SUB + SUB - 1] for m in range(nb)]

        def span(a, b):                             # over sub-chunks [a, b)
            acc = torch.zeros_like(tot[0])
            for m in range(a, b):
                acc = acc + tot[m]
            return acc[:, :, None]

        def K3(ref):                                # rows s < 16 ref
            return torch.cat([kc[:, :, blk(j)] * torch.exp(
                span(j + 1, ref) + (tot[j][:, :, None] - Al[:, :, blk(j)]))
                for j in range(ref)], 2)

        def R3(ref):                                # rows t >= 16 ref
            return torch.cat([rc[:, :, blk(i)] * torch.exp(
                span(ref, i) + Ae[:, :, blk(i)]) for i in range(ref, nb)], 2)
        Q = dyc @ vc.transpose(-1, -2)
        Lh, Ll = _split(L)
        Gh, Gl = _split(G)
        X1 = dyc @ Lh.transpose(-1, -2) + dyc @ Ll.transpose(-1, -2)
        X2 = vc @ Gh.transpose(-1, -2) + vc @ Gl.transpose(-1, -2)
        drp, dkp, alpha, beta = (torch.zeros_like(rc) for _ in range(4))
        dvp = torch.zeros_like(vc)
        asum, bsum, tpart = [None] * nb, [None] * nb, {}
        for m in range(nb):
            sl = blk(m)
            # t side: m's tokens as the later one
            ea = torch.exp(Ae[:, :, sl])
            fr = rc[:, :, sl] * ea
            X = torch.zeros_like(rc[:, :, sl])
            for js in range(m):
                X = X + _mm3(Q[:, :, sl, blk(js)], K3(m)[:, :, blk(js)])
                if js + 1 < m:                      # N over s before js + 1
                    tpart[m, js + 1] = (fr * X).sum(2)
            eA = torch.exp(span(0, m)) * ea
            drp[:, :, sl] = eA * X1[:, :, sl] + ea * X
            a = rc[:, :, sl] * eA * X1[:, :, sl]
            alpha[:, :, sl] = a + fr * X
            asum[m] = a.sum(2)
            # s side: m's tokens as the earlier one
            own = tot[m][:, :, None] - Al[:, :, sl]
            eo, eC = torch.exp(own), torch.exp(span(m + 1, nb) + own)
            dvp[:, :, sl] = _mm3(kc[:, :, sl] * eC, G)
            Y = torch.zeros_like(kc[:, :, sl])
            if m < nb - 1:
                r3 = R3(m + 1)
                khat = _bf(K3(m + 1)[:, :, sl])
                for jt in range(m + 1, nb):
                    rows = slice((jt - m - 1) * SUB, (jt - m) * SUB)
                    Y = Y + _mm3(Q[:, :, blk(jt), sl].transpose(-1, -2),
                                 r3[:, :, rows])
                    Pt = khat @ _bf(r3[:, :, rows]).transpose(-1, -2)
                    dvp[:, :, sl] = dvp[:, :, sl] + _bf(Pt) @ dyc[:, :, blk(jt)]
            dkp[:, :, sl] = eC * X2[:, :, sl] + eo * Y
            b = kc[:, :, sl] * eC * X2[:, :, sl]
            beta[:, :, sl] = b + kc[:, :, sl] * eo * Y
            bsum[m] = b.sum(2)
        lg = torch.exp(span(0, nb)[:, :, 0]) * (L * G).sum(-1)
        vd = torch.diagonal(Q, dim1=-2, dim2=-1)    # v_t . dy_t
        bonus = (rc * u[:, None] * kc).sum(-1)
        acc = torch.zeros_like(rc)
        dvd = torch.zeros_like(vc)
        for M in range(nb):                         # the diagonal tiles
            sl = blk(M)
            ex = Ae[:, :, sl, None, :] - Al[:, :, None, sl, :]
            E = torch.exp(ex.masked_fill(tri[:, :, None] == 0, -math.inf))
            q = Q[:, :, sl, sl][..., None] * tri[:, :, None]
            rr, kk = rc[:, :, sl], kc[:, :, sl]
            drp[:, :, sl] += (q * kk[:, :, None] * E).sum(3)
            dkp[:, :, sl] += (q * rr[:, :, :, None] * E).sum(2)
            x = rr[:, :, :, None] * kk[:, :, None] * E       # [tau, s, k]
            dvd[:, :, sl] = (x.sum(-1) * tri).transpose(-1, -2) @ dyc[:, :, sl]
            pre = torch.cumsum(q * x, 3)                      # N over s
            for t in range(1, SUB):                           # s < t < tau
                acc[:, :, M * SUB + t] += pre[:, :, t + 1:, t - 1].sum(2)
            rest = lg
            for I in range(M + 1, nb):
                if M > 0:
                    rest = rest + tpart[I, M]
            for I in range(M + 1, nb):
                rest = rest + asum[I]
            for J in range(M):
                rest = rest + bsum[J]
            acc[:, :, sl] += _after(alpha[:, :, sl]) + _before(beta[:, :, sl]) \
                + rest[:, :, None]
        dr[:, :, tb:te] = (drp + u[:, None] * kc * vd[..., None])[:, :, :n]
        dk[:, :, tb:te] = (dkp + u[:, None] * rc * vd[..., None])[:, :, :n]
        dv[:, :, tb:te] = (dvp + dvd + bonus[..., None] * dyc)[:, :, :n]
        dw[:, :, tb:te] = acc[:, :, :n]
        du = du + (rc * kc * vd[..., None]).sum((0, 2))
    return dr, dk, dv, dw, du, dstate


def _recurrence64(r, k, v, w, u, state, dy, ds_out):
    """The token recurrence of ``rwkv6_scan_bwd_ref`` in fp64."""
    r, k, v, w, u, dy = (x.double() for x in (r, k, v, w, u, dy))
    B, H, T, K = r.shape
    V = v.shape[-1]
    S = torch.zeros((B, H, K, V), dtype=torch.float64) if state is None \
        else state.double()
    states = []
    for t in range(T):
        states.append(S)
        S = S * torch.exp(w[:, :, t])[..., None] \
            + k[:, :, t, :, None] * v[:, :, t, None, :]
    G = torch.zeros((B, H, K, V), dtype=torch.float64) if ds_out is None \
        else ds_out.double()
    vd = (v * dy).sum(-1)
    bonus = (r * u[:, None] * k).sum(-1)
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (r, k, v, w))
    for t in range(T - 1, -1, -1):
        d = torch.exp(w[:, :, t])
        dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", states[t], dy[:, :, t]) \
            + u * k[:, :, t] * vd[:, :, t, None]
        dk[:, :, t] = torch.einsum("bhkv,bhv->bhk", G, v[:, :, t]) \
            + u * r[:, :, t] * vd[:, :, t, None]
        dv[:, :, t] = torch.einsum("bhkv,bhk->bhv", G, k[:, :, t]) \
            + bonus[:, :, t, None] * dy[:, :, t]
        dw[:, :, t] = d * (states[t] * G).sum(-1)
        G = d[..., None] * G + r[:, :, t, :, None] * dy[:, :, t, None, :]
    du = (r * k * vd[..., None]).sum((0, 2))
    return dr, dk, dv, dw, du, G


@pytest.mark.parametrize("T,V,with_state,decay", [
    (200, 16, False, None), (200, 48, True, None),    # ragged tail
    (64, 16, True, None),                             # one chunk
    (37, 32, True, None), (16, 16, True, None), (1, 16, True, None),
    (130, 16, True, CLAMP_DECAY),                     # the floor everywhere
    (130, 16, True, "boundary"),                      # across chunks 0|1
    (130, 16, True, "subchunk"),                      # across sub-chunks 0|1
])
def test_matrix_form_backward_equals_the_recurrence(T, V, with_state, decay):
    r, k, v, w, u, s0 = (torch.as_tensor(a) for a in rwkv_inputs(
        1, 2, T, 64, V, seed=T + V + 7,
        decay=decay if isinstance(decay, float) else None))
    if decay == "boundary":
        w[:, :, 56:72] = CLAMP_DECAY
    elif decay == "subchunk":
        w[:, :, 8:24] = CLAMP_DECAY
    r, k, v = (x.bfloat16() for x in (r, k, v))    # the body's input type
    rng = np.random.default_rng(T + V + 8)
    dy = torch.as_tensor(rng.standard_normal((1, 2, T, V)).astype(np.float32))
    ds = torch.as_tensor(rng.standard_normal((1, 2, 64, V)).astype(np.float32))
    dy = dy.bfloat16()
    state, ds_out = (s0, ds) if with_state else (None, None)
    got = _chunked_matrix_scan_bwd(r, k, v, w, u, state, dy, ds_out)
    for want, what in ((ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy,
                                               ds_out), "plain"),
                       (_recurrence64(r, k, v, w, u, state, dy, ds_out),
                        "fp64")):
        for name, g, wnt, tol in zip(NAMES, got, want, _tols("bfloat16")):
            _close(g, wnt.double().numpy(), tol,
                   f"{name} T={T} V={V} decay={decay} vs {what}")
    # at the floor dw's terms are single paths through w_t: each entry keeps
    # its own precision, however small
    if decay == CLAMP_DECAY:
        want = _recurrence64(r, k, v, w, u, state, dy, ds_out)[3]
        np.testing.assert_allclose(got[3].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-6 * math.exp(decay))


def _case_tensors(B, H, T, K, V, dtype, with_state, offset):
    """Zero tensors laid out as the on-card tests lay out SCAN_BWD_CASES:
    r, k, v, w_log, dy (contiguous, or one element into a buffer with
    ``offset``) and the state."""
    def make(width, typ):
        t = torch.zeros((B, H, T, width), dtype=typ)
        if not offset:
            return t
        return torch.zeros(t.numel() + 1, dtype=typ)[1:].view(t.shape)
    typ = getattr(torch, dtype)
    tensors = [make(K, typ), make(K, typ), make(V, typ), make(K, torch.float32),
               make(V, typ)]
    state = torch.zeros((B, H, K, V)) if with_state else None
    return tensors, state


@pytest.mark.parametrize("case", range(len(SCAN_BWD_CASES)))
def test_scan_bwd_body_at_every_card_case(case):
    (label, B, H, T, K, V, dtype, with_state, _, offset,
     expect) = SCAN_BWD_CASES[case]
    tensors, state = _case_tensors(B, H, min(T, 65), K, V, dtype, with_state,
                                   offset)
    aligned = all(build.rows16(t) for t in tensors) \
        and (state is None or build.aligned16(state))
    assert aligned == (not offset), label
    assert rs.scan_bwd_body(K, V, getattr(torch, dtype), aligned) == expect, label


@pytest.mark.parametrize("K", [16, 32, 64])
def test_scan_bwd_body_rule(K):
    for V in range(1, 257):
        for dtype in (torch.bfloat16, torch.float32):
            for aligned in (True, False):
                mma = dtype == torch.bfloat16 and aligned and K == 64 \
                    and V % 16 == 0 and V <= 128
                assert rs.scan_bwd_body(K, V, dtype, aligned) \
                    == ("mma" if mma else "simt"), (K, V, dtype, aligned)


@pytest.mark.parametrize("K,V,dtype", [(48, 64, torch.bfloat16),
                                       (64, 257, torch.bfloat16),
                                       (64, 0, torch.float32),
                                       (64, 64, torch.float16)])
def test_what_no_scan_bwd_body_takes_raises(K, V, dtype):
    with pytest.raises(ValueError):
        rs.scan_bwd_body(K, V, dtype, True)


def test_cpu_scan_bwd_counts_no_launch_by_body():
    ops.reset_launch_counts()
    assert rs.rwkv6_scan_bwd.launches_by_body == {"simt": 0, "mma": 0}
    inputs = _inputs(37, 16, "bfloat16", True, seed=5)
    rs.rwkv6_scan_bwd(*inputs)
    assert ops.launch_counts()["rwkv6_scan_bwd"] == 0
    assert set(rs.rwkv6_scan_bwd.launches_by_body.values()) == {0}
