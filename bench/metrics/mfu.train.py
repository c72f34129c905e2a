"""``mfu.train``: the window's model operations (``roofline/model_<family>``:
3 x the forward's matmul and attention or scan products, a step) over
its wall time, as a share of the card's peak at the configuration's
precision (989 TFLOP/s for bf16), in %."""

from bench import harness
from bench.roofline import peaks


def read(run):
    h = run.host
    if "steps" not in h:
        return None
    model = harness.roofline("model_" + run.config["reference"])
    flops = model.train_flops(run.config, run.mix["global_batch"],
                              run.mix["seq_len"]) * h["steps"]
    peak = peaks.OPS_PER_S[run.config["torch_dtype"]]
    return 100.0 * flops / (h["window_s"] * peak)
