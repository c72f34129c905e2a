"""``mfu.prefill``: the model operations of the window's prompts' own
tokens (not their pads) over the batches' prefill walls (hand-off to
first token), as a share of the card's peak at the configuration's
precision, in %."""

from bench import harness
from bench.roofline import peaks


def read(run):
    batches = run.host.get("batches")
    if not batches:
        return None
    model = harness.roofline("model_" + run.config["reference"])
    flops = sum(model.forward_flops(run.config, b["lengths"])
                for b in batches)
    wall = sum(b["ttft_s"] for b in batches)
    return 100.0 * flops / (wall * peaks.OPS_PER_S[run.config["torch_dtype"]])
