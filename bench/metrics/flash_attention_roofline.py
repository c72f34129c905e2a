"""``flash_attention_roofline``: the traced prefill launches' least time
(``roofline/flash_attention.py``, from the shapes) over their traced device
time, in %."""

from bench.roofline.share import share


def read(run):
    return share(run, "flash_attention", "prefill")
