"""The capture and instantiation of each new graph's device loop
(``loop.capture`` and ``loop.instantiate`` spans), summed a request and
averaged over the traced window's requests."""

from benchmark import spans


def read(run):
    return spans.per_request_ms(spans.recorded(), "loop.capture",
                                "loop.instantiate")
