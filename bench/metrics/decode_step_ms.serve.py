"""``decode_step_ms.serve``: the median wall time of the window's decode
steps, from the start of one of the server's steps to the next (the last
to the end of ``generate``), in ms. Host-paced."""

import statistics


def read(run):
    steps = [d for b in run.host.get("batches", ())
             for d in b["decode_step_s"]]
    return statistics.median(steps) * 1e3 if steps else None
