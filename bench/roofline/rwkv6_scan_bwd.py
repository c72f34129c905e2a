"""``rwkv6_scan_bwd``: its calls in a traced training unit (one per layer
and microbatch a step), and each call's operations and bytes from its
shapes alone, whatever body runs (not the body's saved chunk states).

Operations, by the definition of the recurrence's gradient per token,
head and state element: the state S_{t-1} again (3 K V), the adjoint G_{t-1}
= diag(exp(w_t)) G_t + r_t dy_t^T (3 K V), dr_t = S_{t-1} dy_t, dk_t = G_t
v_t, dv_t = G_t^T k_t and dw_t = (S_{t-1} * G_t) summed over V (2 K V
each): 14 K V; and the bonus's terms (15 K + 4 V). Bytes: r, k, v, dy
(the activations' type), w (fp32), u (and a state and its cotangent,
when given) read once; dr, dk, dv, dw (fp32), du written once."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import rwkv6_scan as fwd
from .peaks import least_s as _least

PIECES = ("rwkv6_bwd",)


def calls(cfg, work) -> List[Tuple[Dict, int]]:
    return fwd.calls(cfg, work) if work["phase"] == "train" else []


def flops(c) -> float:
    K, V = c["K"], c["V"]
    return c["B"] * c["H"] * c["T"] * (14 * K * V + 15 * K + 4 * V)


def nbytes(c) -> float:
    B, H, T, K, V, io = c["B"], c["H"], c["T"], c["K"], c["V"], c["io_bytes"]
    state = 3 * B * H * K * V * 4 if c["state"] else 0   # S0, dS_T in; dS0
    return (B * H * T * (2 * K + 2 * V) * io + B * H * T * K * 4 + H * K * 4
            + B * H * T * (2 * K + V) * io + B * H * T * K * 4 + H * K * 4
            + state)


def least_s(c, precision: str) -> float:
    return _least(flops(c), nbytes(c), precision)
