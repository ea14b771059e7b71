"""The device loop's round on the card: the CUDA-event time of the
graph launches (``loop.run`` counter ``device_ms``) over the rounds of
the algorithm drivers that ran them (counter ``rounds``), traced
window."""

from benchmark import spans


def read(run):
    return spans.loop_round_us(spans.recorded())
