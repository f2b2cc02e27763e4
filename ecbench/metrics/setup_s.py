"""setup_s: from the first statement of run.py to the start of the
window, s."""


def read(run):
    return run.setup_s
