"""``forward_ms.train``: device milliseconds of a traced training step's
forward: the median over the recorded steps of the summed ``device_ms``
of the step's ``train.forward`` spans (one a microbatch: the loss, from
the embedding to the cross entropy). ``device_ms`` is the CUDA stream's
time between a span's two marks: the device work plus any idle inside."""

from bench import spans


def read(run):
    return spans.step_device_ms(run, "train.forward")
