"""bucket_grams_roofline.train: the least time of the bucket grams' needed
work in a sweep (``run.work["gram"]``) over the device time of the
operations launched inside the port's ``als.grams`` marks of the traced
call, per traced sweep, in %: ``gram_roofline.train`` from the program's
own marks."""

from benchmark import program_spans, work


def read(run):
    need = run.work.get("gram")
    ns = program_spans.launched_ns(run, "als.grams")
    if need is None or not ns or not run.traced_units:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
