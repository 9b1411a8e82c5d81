"""setup_s: seconds from the process's start to the first item of the
window: imports, the card, the kernels' build or load, the parse and
scene build, the warm-up (host clock)."""


def read(run):
    return run.setup_s
