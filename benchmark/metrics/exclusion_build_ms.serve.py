"""exclusion_build_ms.serve: host ms of the port's ``serve.exclusions``
spans (each level's exclusion lists and their map to serving rows) inside
the window's calls, over the ``serve.recommend`` spans there: per call."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "serve.exclusions",
                                     "serve.recommend")
