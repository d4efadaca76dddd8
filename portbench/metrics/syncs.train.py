"""syncs.train: the program's ``syncs`` counter an epoch (train and
test), mean over the window's epochs (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    return spans.per_epoch(rec, lambda r: r.counters.get('syncs', 0))
