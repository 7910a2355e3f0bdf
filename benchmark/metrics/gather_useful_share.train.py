"""gather_useful_share.train: the real ratings among the gather slots the
bucket grams walk (``als.gather_ratings`` over ``als.gather_slots``, the
port's counters over the whole process), in %."""

from benchmark import program_spans


def read(run):
    s = program_spans.totals()
    if s is None:
        return None
    slots = s["counters"].get("als.gather_slots", 0)
    if not slots:
        return None
    return 100.0 * s["counters"].get("als.gather_ratings", 0) / slots
