"""``decode_dispatch_ms.serve``: the median host milliseconds of the
traced batch's ``serve.step`` spans of phase ``decode``: how long the
host takes to enqueue one decode step's forward (every layer's
kernels). It exists only under the profiler, whose cost a launch
inflates it: compare it only with itself. A change to the decode loop is
judged end to end by ``serve_tokens_per_s`` and, untraced, by
``decode_step_ms.serve``."""

from bench import spans


def read(run):
    return spans.median_host_ms(
        spans.recorded(run, "serve.step", "decode", phase="decode"))
