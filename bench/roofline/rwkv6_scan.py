"""``rwkv6_scan`` (forward): its calls in a traced unit (one per layer, a
microbatch), and each call's operations and bytes from its shapes alone.

Operations, by the recurrence's definition per token, head and state
element: S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T (3 K V) and y_t = r_t
S_{t-1} (2 K V) plus the bonus (r_t . (u k_t)) v_t (3 K + 2 V): 5 K V + 3
K + 2 V. Bytes: r, k, v (the activations' type), w (fp32), u and the
state (fp32) read once; y written once, the final state once. The
arithmetic of ``chip_smoke.lm_kernel_entries``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import dtype_bytes, least_s as _least

PIECES = ("rwkv6_chunk_state", "rwkv6_chunk_carry", "rwkv6_fwd")


def _shape(cfg, B: int, T: int, state: bool) -> Dict:
    K = cfg["head_dim"]
    return {"B": B, "H": cfg["hidden_size"] // K, "T": T, "K": K, "V": K,
            "state": state, "io_bytes": dtype_bytes(cfg["torch_dtype"])}


def calls(cfg, work) -> List[Tuple[Dict, int]]:
    L = cfg["num_hidden_layers"]
    if work["phase"] == "prefill":   # the server passes its cache's state
        return [(_shape(cfg, work["rows"], work["seq"], True), L)]
    if work["phase"] == "train":
        mb = work["microbatch"]
        return [(_shape(cfg, work["rows"] // mb, work["seq"], False),
                 L * mb * work["units"])]
    return []


def flops(c) -> float:
    K, V = c["K"], c["V"]
    return c["B"] * c["H"] * c["T"] * (5 * K * V + 3 * K + 2 * V)


def nbytes(c) -> float:
    B, H, T, K, V = c["B"], c["H"], c["T"], c["K"], c["V"]
    return (B * H * T * (2 * K + 2 * V) * c["io_bytes"] + B * H * T * K * 4
            + H * K * 4 + B * H * K * V * 4 * (2 if c["state"] else 1))


def least_s(c, precision: str) -> float:
    return _least(flops(c), nbytes(c), precision)
