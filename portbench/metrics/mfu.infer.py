"""mfu.infer: the detector's forward FLOPs for every kept tile of every
frame of the window's calls (the reference's count a tile x the movie's
kept tiles x frames) over the window's seconds x the f32 peak, in %."""
from portbench.lib import peaks


def read(rec):
    if not rec.get('calls'):
        return None
    flops = sum(rec['flops_per_tile'] * rec['kept_tiles'][c['movie']]
                * c['frames'] for c in rec['calls'])
    return 100 * flops / (rec['window_s'] * peaks.F32_FLOPS)
