"""Set-up: wall seconds from the process's start to the window's start."""


def read(out):
    return out.setup_s
