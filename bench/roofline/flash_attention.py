"""``flash_attention`` (forward): its calls in a traced unit, and each
call's operations and bytes from its shapes alone.

Operations: q.k over hd and p.v over hdv for every (query, key) pair the
causal and window masks leave visible, two a multiply-add. Bytes: q read
and the output written once, each visible K and V row read once, in the
types the call gets (a served prefill reads K/V from the server's fp32
cache). Queries sit at the tail of the keys. The arithmetic of
``chip_smoke.lm_kernel_entries`` and ``_visible_keys``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .peaks import dtype_bytes, least_s as _least

PIECES = ("flash_fwd", "flash_combine")


def visible(Tq: int, Tk: int, causal: bool, window) -> Tuple[int, int]:
    """(visible (query, key) pairs, keys any query sees) of one head."""
    q = np.arange(Tq) + (Tk - Tq)
    hi = np.minimum(Tk - 1, q) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(0, q - window + 1) if window is not None \
        else np.zeros(Tq, np.int64)
    n = hi - lo + 1
    seen = n > 0
    if not seen.any():
        return 0, 0
    return int(n[seen].sum()), int(hi[seen].max() - lo[seen].min() + 1)


def _shape(cfg, B: int, T: int, kv_dtype: str) -> Dict:
    return {"B": B, "H": cfg["num_attention_heads"],
            "KV": cfg["num_key_value_heads"], "Tq": T, "Tk": T,
            "hd": cfg["head_dim"], "hdv": cfg["head_dim"], "causal": True,
            "window": cfg.get("sliding_window"),
            "q_bytes": dtype_bytes(cfg["torch_dtype"]),
            "kv_bytes": dtype_bytes(kv_dtype)}


def calls(cfg, work) -> List[Tuple[Dict, int]]:
    """(call, how many) of one traced segment's ``work``."""
    L = cfg["num_hidden_layers"]
    if work["phase"] == "prefill":
        return [(_shape(cfg, work["rows"], work["seq"],
                        cfg["assumed"]["serve_cache_dtype"]), L)]
    if work["phase"] == "train":
        mb = work["microbatch"]
        return [(_shape(cfg, work["rows"] // mb, work["seq"],
                        cfg["torch_dtype"]), L * mb * work["units"])]
    return []


def flops(c) -> float:
    pairs, _ = visible(c["Tq"], c["Tk"], c["causal"], c["window"])
    return 2.0 * (c["hd"] + c["hdv"]) * c["B"] * c["H"] * pairs


def nbytes(c) -> float:
    _, keys = visible(c["Tq"], c["Tk"], c["causal"], c["window"])
    return (c["B"] * c["H"] * c["Tq"] * (c["hd"] + c["hdv"]) * c["q_bytes"]
            + c["B"] * c["KV"] * keys * (c["hd"] + c["hdv"]) * c["kv_bytes"])


def least_s(c, precision: str) -> float:
    return _least(flops(c), nbytes(c), precision)
