"""mcf_solve_ms: the program's ``mcf.solve`` span a call (the native
min-cost-flow solve on the host, without the graph's build), mean over
the window's calls, in ms (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    v = spans.per_call(rec, lambda r: spans.seconds(r, 'mcf.solve'))
    return None if v is None else 1e3 * v
