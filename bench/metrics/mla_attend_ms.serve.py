"""``mla_attend_ms.serve``: device milliseconds a traced decode step spends
in MLA's attention over the expanded K and V: the median over the traced
batch's decode steps of the summed ``device_ms`` of the step's
``mla.attend`` spans (one a layer, around ``ops.attention``: the
``flash_attention`` kernel at hd 96 / hdv 64 over fp32 K and V)."""

from bench.serve_spans import decode_step_device_ms


def read(run):
    return decode_step_device_ms(run, "mla.attend")
