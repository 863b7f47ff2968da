"""setup_s: seconds from the start of the process to the start of the
window: imports, the card's context, the weights and inputs drawn from the
seed, the kernels' build on a checkout's first run, and the warm-up."""


def read(run):
    return run.setup_s
