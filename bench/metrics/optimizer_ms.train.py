"""``optimizer_ms.train``: device milliseconds of a traced training step's
optimizer: the median over the recorded steps of the ``device_ms`` of the
step's ``train.optimizer`` span (the clip to a global norm, the
optimizer's update, the update's apply to the parameters). ``device_ms``
is the CUDA stream's time between a span's two marks: the device work
plus any idle inside."""

from bench import spans


def read(run):
    return spans.step_device_ms(run, "train.optimizer")
