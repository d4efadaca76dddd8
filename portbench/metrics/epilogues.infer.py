"""epilogues.infer: the program's ``epilogues`` counter a call (launches of
the conv-block epilogue kernel, ``ops/epilogue_cuda.py``: one a fused conv
block a CNN group), mean over the window's calls (``lib/spans.py``). A
program without that kernel gives nothing."""
import importlib.util

from portbench.lib import spans


def read(rec):
    if importlib.util.find_spec('axtrack_tpu_torch.ops.epilogue_cuda') is None:
        return None
    return spans.per_call(rec, lambda r: r.counters.get('epilogues', 0))
