"""``serve_tokens_per_s``: every token the window's batches generated over
the window's wall time (each batch ends with its tokens on the host)."""


def read(run):
    h = run.host
    if "batches" not in h:
        return None
    return h["tokens"] / h["window_s"]
