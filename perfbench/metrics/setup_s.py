"""setup_s: from the start of the process to the end of the warm-up set:
imports, the card, the matrix's generation and ``from_assembly``,
``register`` (plan, pack or its reload from the plan cache, bind), the
kernels' build or load, the right-hand sides, one set of the cell's own
width."""


def read(run):
    return run.setup_s
