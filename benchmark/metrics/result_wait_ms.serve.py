"""result_wait_ms.serve: host ms of the port's ``serve.readback`` spans
(the results' copy to the host, and the wait for what the device still has
to do by then) inside the window's calls, over the ``serve.recommend``
spans there: per call."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "serve.readback",
                                     "serve.recommend")
