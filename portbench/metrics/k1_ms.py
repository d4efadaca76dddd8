"""k1_ms: kernel K1's device milliseconds a call (the CUDA events its
wrapper records around each launch, band pass included), mean over the
window's calls."""


def read(rec):
    vals = [c['k1_ms'] for c in rec.get('calls', []) if 'k1_ms' in c]
    return sum(vals) / len(vals) if vals else None
