"""``eager_ms.train``: device milliseconds a traced training step spends
in kernels that are neither the port's hand-written kernels nor cuBLAS
products: elementwise ops, copies, casts, fills and reductions of
``models/`` and ``optim/``."""

from bench import tracing


def read(run):
    segs = tracing.whole(run.segments, "train")
    if segs is None:
        return None
    ms = sum((b - a) / 1e3 for s in segs for n, a, b in s["events"]
             if tracing.is_eager(n))
    return ms / sum(s["units"] for s in segs)
