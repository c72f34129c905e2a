"""``idle_share.serve``: the share of a traced batch's wall time (its
prefill and its decode steps) in which the card ran nothing, in %."""

from bench import tracing


def read(run):
    segs = [tracing.whole(run.segments, p) for p in ("prefill", "decode")]
    if None in segs:
        return None
    segs = segs[0] + segs[1]
    busy = sum(tracing.busy_s(s["events"]) for s in segs)
    return 100.0 * (1.0 - busy / sum(s["wall_s"] for s in segs))
