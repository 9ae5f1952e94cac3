"""setup_s (s, host clock): from the start of ``run.py`` to the window's
start: imports, kernel builds at first use, the data pool, the state,
the checked and the warm steps; above one chip, the last rank's start."""


def read(run):
    return run.setup_s
