"""``setup_s``: seconds from the process's start (before torch is
imported) to the window's: imports, the kernels' build on a checkout's
first run, weights drawn on the card, the warm steps or batch."""


def read(run):
    return run.setup_s
