"""syncs.infer: the program's ``syncs`` counter a call (waits of the host
for the card: copies to the host, blocking copies to the card, boolean
indexing), mean over the window's calls (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    return spans.per_call(rec, lambda r: r.counters.get('syncs', 0))
