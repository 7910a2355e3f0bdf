"""layout_build_s: host seconds of the port's two ``layout_from_coo``
calls in the set-up."""


def read(run):
    return run.layout_build_s
