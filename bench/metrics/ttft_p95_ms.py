"""``ttft_p95_ms``: the 95th percentile, over every request served in the
window, of the time from its hand-off to the server's ``generate`` to its
first token on the host (every request of a batch gets its first token
at once: the batch's prefill)."""

import statistics


def read(run):
    h = run.host
    if not h.get("batches"):
        return None
    ttft = [b["ttft_s"] for b in h["batches"] for _ in b["lengths"]]
    if len(ttft) < 2:
        return ttft[0] * 1e3
    return statistics.quantiles(ttft, n=100, method="inclusive")[94] * 1e3
