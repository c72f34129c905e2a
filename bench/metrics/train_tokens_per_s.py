"""``train_tokens_per_s``: every token trained in the window over the
window's wall time, which ends in a synchronize."""


def read(run):
    h = run.host
    if "steps" not in h:
        return None
    return h["steps"] * h["tokens_per_step"] / h["window_s"]
