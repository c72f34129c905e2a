"""``flash_attention_bwd``: its calls in a traced training unit (one per
layer and microbatch a step, at the forward's shapes), and each call's
operations and bytes from its shapes alone, whatever body runs.

Operations, by the definition of the gradient from the forward's saved
state (q, k, v, o, dO and each row's log-sum-exp): the scores S = q k^T
again (hd), dV = P^T dO (hdv), dP = dO V^T (hdv), dQ = dS K (hd), dK =
dS^T Q (hd) for every visible pair, two a multiply-add: 2 (3 hd + 2 hdv)
a pair. Bytes: q, o, dO, k, v and the log-sum-exp read once, dq, dk, dv
written once; nothing a body saves or reads again."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import flash_attention as fwd
from .peaks import least_s as _least

PIECES = ("flash_bwd",)


def calls(cfg, work) -> List[Tuple[Dict, int]]:
    return fwd.calls(cfg, work) if work["phase"] == "train" else []


def flops(c) -> float:
    pairs, _ = fwd.visible(c["Tq"], c["Tk"], c["causal"], c["window"])
    return 2.0 * (3 * c["hd"] + 2 * c["hdv"]) * c["B"] * c["H"] * pairs


def nbytes(c) -> float:
    _, keys = fwd.visible(c["Tq"], c["Tk"], c["causal"], c["window"])
    rows_q = c["B"] * c["H"] * c["Tq"]
    rows_k = c["B"] * c["KV"] * keys
    # in: q, o, dO; k, v; lse (fp32). out: dq; dk, dv
    return (rows_q * (2 * c["hd"] + 2 * c["hdv"]) * c["q_bytes"]
            + 2 * rows_k * (c["hd"] + c["hdv"]) * c["kv_bytes"]
            + rows_q * 4)


def least_s(c, precision: str) -> float:
    return _least(flops(c), nbytes(c), precision)
