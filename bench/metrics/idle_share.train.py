"""``idle_share.train``: the share of the traced training steps' wall time
in which the card ran nothing, in %: 1 - (union of device activity) /
(host clock over the steps, ended by a synchronize)."""

from bench import tracing


def read(run):
    segs = tracing.whole(run.segments, "train")
    if segs is None:
        return None
    busy = sum(tracing.busy_s(s["events"]) for s in segs)
    return 100.0 * (1.0 - busy / sum(s["wall_s"] for s in segs))
