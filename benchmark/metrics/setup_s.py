"""setup_s: seconds from the process's start to the window's: imports,
weights and traffic from the seed, the program's set-up, the warm-up of
every shape the cell uses (and, in a checkout's first run, the build of
the port's kernels)."""


def read(r):
    return r.setup_s
