"""The least time the chip could take for the association's geodesic
work (the work of kernel K1), from the inputs alone, so that the count
holds whatever implements it.

- Bytes: each source's window of the mask read once as bits (window^2 /
  8), every detection read once (two int32), and each distance of the
  lookback pairs written once (4 bytes), over the HBM rate.
- Operations: ``reference/geodesic.py:OPS_PER_CELL`` (the least update of
  a cell: the minimum over its 4 neighbours, plus the step) on each cell
  the reference's search reached from each source, over the f32 rate. A
  chamfer sweep repeats this for every cell of its band a pass, and again
  for each further sweep; the count holds to the once that any method
  needs.

The least time is the larger of the two; ``least`` says which.
"""
from . import peaks
from ..reference.geodesic import OPS_PER_CELL


def least(work):
    """(seconds, 'bytes' or 'operations') of one movie's association work
    (``reference.geodesic.lookback``'s record)."""
    nbytes = (work['sources'] * work['window'] ** 2 / 8
              + work['n_dets'] * 8 + work['n_pairs'] * 4)
    ops = OPS_PER_CELL * float(work['reached'])
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = ops / peaks.F32_FLOPS
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')
