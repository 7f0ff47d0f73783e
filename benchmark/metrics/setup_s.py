"""setup_s: process start to the first timed step, on the host clock."""


def read(run):
    return run.setup_s
