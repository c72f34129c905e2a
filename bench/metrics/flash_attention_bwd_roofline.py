"""``flash_attention_bwd_roofline``: the traced train launches' least time
(``roofline/flash_attention_bwd.py``, from the shapes) over their traced device
time, in %."""

from bench.roofline.share import share


def read(run):
    return share(run, "flash_attention_bwd", "train")
