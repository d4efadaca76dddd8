"""h2d.infer: the program's ``h2d`` counter a call (copies from the host
to the card), mean over the window's calls (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    return spans.per_call(rec, lambda r: r.counters.get('h2d', 0))
