"""k1_roofline: the least time the chip could take for the association's
geodesic work of each call's movie (``lib/k1work.py``: bytes or
operations, whichever bounds) over K1's measured time, summed over the
window's calls, in %."""
from portbench.lib import k1work


def read(rec):
    work = rec.get('k1_work') or {}
    calls = [c for c in rec.get('calls', []) if c.get('k1_ms')]
    if not calls or any(c['movie'] not in work for c in calls):
        return None
    least = {i: k1work.least(w)[0] for i, w in work.items()}
    return 100 * sum(least[c['movie']] for c in calls) / sum(
        c['k1_ms'] / 1e3 for c in calls)
