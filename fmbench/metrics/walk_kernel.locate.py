"""LF walks per call that the walk's CUDA kernel served (``csrc/lf_walk.cu``,
one launch for every row's walk): 1 where a locate call walks on a card, 0
where it walks in the plain loop (the program's ``COUNTS["walk_kernel"]``,
counted at each launch, over ``COUNTS["calls"]``, both counted only in the
traced window).  None for a program without the kernel."""
from fmbench import spans


def read(run):
    try:
        from sview_fmindex_tpu_torch.ops import locate
    except ImportError:
        return None
    if not hasattr(locate, "walk_rows_cuda"):
        return None
    return spans.per_call(run, "walk_kernel")
