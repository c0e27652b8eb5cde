"""setup_s: seconds from the process's start to the window's start (imports,
weights, the program's build and warm-up; kernel builds in a checkout's
first run). Host clock."""


def read(run):
    return run.setup_s
