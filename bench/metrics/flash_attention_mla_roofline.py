"""``flash_attention_mla_roofline``: the traced prefill's ``flash_attention``
launches' least time at MLA's shapes (``roofline/flash_attention_mla.py``:
H = KV heads, hd 96 / hdv 64, fp32 K and V from the server's cache) over
their traced device time, in %.

Unlike ``roofline/share.share`` it does not ask the prefill's trace to be
whole. The serving driver traces a prefill once, and a trace can lose its
last events, the last layers' launches among them. Every layer's call has
the same shape, so the share is taken over the launches the trace holds:
each one's least time over its traced time. Nothing where the trace holds
no launch, more launches than the prefill makes, or ``flash_combine``
launches that do not pair one to one with ``flash_fwd``'s."""

from bench import harness, tracing


def _count(events, piece: str) -> int:
    return sum(piece in name for name, _, _ in events)


def read(run):
    mod = harness.roofline("flash_attention_mla")
    precision = run.config["torch_dtype"]
    least = spent = 0.0
    for s in run.segments:
        if s["name"] != "prefill":
            continue
        ((call, n),) = mod.calls(run.config, s["work"])
        fwd = _count(s["events"], "flash_fwd")
        combine = _count(s["events"], "flash_combine")
        if not 0 < fwd <= n or combine not in (0, fwd):
            return None
        least += fwd * mod.least_s(call, precision)
        spent += tracing.time_in(s["events"], mod.PIECES)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
