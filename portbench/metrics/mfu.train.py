"""mfu.train: FLOPs of the window's epochs (3 x the forward a train tile:
forward and the two products of the backward; 1 x a test tile) over the
window's seconds x the f32 peak, in %."""
from portbench.lib import peaks


def read(rec):
    if not rec.get('epochs'):
        return None
    tiles = sum(3 * e['train_tiles'] + e['test_tiles']
                for e in rec['epochs'])
    return 100 * tiles * rec['flops_per_tile'] / (
        rec['window_s'] * peaks.F32_FLOPS)
