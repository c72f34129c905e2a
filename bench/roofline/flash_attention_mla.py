"""``flash_attention`` (forward) at MLA's shapes: its calls in a traced
prefill, and each call's operations and bytes (``flash_attention.py``'s
``flops`` and ``nbytes``, over the pairs its ``visible`` counts).

Every head has its own keys (KV = H), q.k over ``qk_nope + qk_rope``
(hd 96 for minicpm3-4b) and p.v over ``v_head_dim`` (hdv 64); q in the
configuration's type, K and V expanded from the server's latent cache
in its type (fp32), causal, no window."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .flash_attention import PIECES, flops, nbytes  # noqa: F401
from .peaks import dtype_bytes, least_s as _least


def _shape(cfg, B: int, T: int) -> Dict:
    H = cfg["num_attention_heads"]
    return {"B": B, "H": H, "KV": H, "Tq": T, "Tk": T,
            "hd": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            "hdv": cfg["v_head_dim"], "causal": True, "window": None,
            "q_bytes": dtype_bytes(cfg["torch_dtype"]),
            "kv_bytes": dtype_bytes(cfg["assumed"]["serve_cache_dtype"])}


def calls(cfg, work) -> List[Tuple[Dict, int]]:
    """(call, how many) of one traced segment's ``work``: a prefill's, one
    a layer; none of another phase."""
    if work["phase"] != "prefill":
        return []
    return [(_shape(cfg, work["rows"], work["seq"]),
             cfg["num_hidden_layers"])]


def least_s(c, precision: str) -> float:
    return _least(flops(c), nbytes(c), precision)
