"""``setup_s``: seconds from the process's start to the first timed
call (imports, the card, the kernel library's load or build, the scene,
the capture and warm-up of the cell's key), on the host's clock."""


def read(run):
    return run.setup_s
