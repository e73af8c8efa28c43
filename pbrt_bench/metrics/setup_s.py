"""Process start to the first timed frame or step: imports, the scene
build on the card, kernel builds (cached after a checkout's first run),
the cell's warm-up and, in a checkout's first inverse run, the target."""


def read(run):
    return run.setup_s
