"""Searches per call that the gather engine's CUDA kernel served
(``csrc/gather_search.cu``, one launch for the seed and every LF step): 1
where a locate call's batch takes the gather engine on a card, 0 where it
takes a stream engine (the program's ``COUNTS["gather_kernel"]``, counted at
each launch, over ``COUNTS["calls"]``, both counted only in the traced
window).  None for a program without the kernel."""
from fmbench import spans


def read(run):
    try:
        from sview_fmindex_tpu_torch.ops import search
    except ImportError:
        return None
    if not hasattr(search, "gather_ranges_cuda"):
        return None
    return spans.per_call(run, "gather_kernel")
