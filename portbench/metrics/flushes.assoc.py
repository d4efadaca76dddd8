"""flushes.assoc: the program's ``flushes`` counter a call (the
association's K1 batches of at most 512 sources), mean over the window's
calls (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    return spans.per_call(rec, lambda r: r.counters.get('flushes', 0))
