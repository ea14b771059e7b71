"""Process start to the first timed request: imports, kernels, the
graph made on the card, the program's graphs, warm-up."""


def read(run):
    return run.setup_s
