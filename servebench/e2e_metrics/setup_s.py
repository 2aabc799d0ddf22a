"""setup_s: from the process's start to the window's opening: imports, the
weights drawn on the card, the kernels loaded (built on a checkout's first
run), the warm-up of the cell's shapes and the traffic's own start (a
closed loop's first admissions, an open loop's lead-in)."""


def read(run, name):
    return run.setup_s
