"""``decode_wait_ms.serve``: the median host milliseconds of the traced
batch's ``serve.sample`` spans (one a decode step): the argmax, the
tokens' copy to the host and their appends, in which the host waits for
the card to finish the step."""

from bench import spans


def read(run):
    return spans.median_host_ms(spans.recorded(run, "serve.sample",
                                               "decode"))
