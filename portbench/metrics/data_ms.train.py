"""data_ms.train: the program's ``prepare_data`` spans an epoch (each
re-tiling with a fresh augmentation draw, redraws included, of the train
and the test epoch), mean over the window's epochs, in ms
(``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    v = spans.per_epoch(rec, lambda r: spans.seconds(r, 'prepare_data'))
    return None if v is None else 1e3 * v
