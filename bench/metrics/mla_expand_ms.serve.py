"""``mla_expand_ms.serve``: device milliseconds a traced decode step spends
expanding MLA's latent cache into each head's K and V: the median over
the traced batch's decode steps of the summed ``device_ms`` of the step's
``mla.expand`` spans (one a layer: the latent's product with ``wkv_b``
over every written slot, then K assembled with the shared rope key).
``device_ms`` is the CUDA stream's time between a span's two marks."""

from bench.serve_spans import decode_step_device_ms


def read(run):
    return decode_step_device_ms(run, "mla.expand")
