"""setup_s: seconds from the start of the process to the start of the
window (imports, inputs, the port's set-up and warm-up, and in a
checkout's first run the build of the port's kernels)."""


def read(run):
    return run.setup_s
