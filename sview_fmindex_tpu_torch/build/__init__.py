"""Build layer of the PyTorch port (mirrors sview_fmindex_tpu.build).

The host construction passes (``suffix_array``, ``bwt``, ``bwm``,
``count_array``, ``dense_lut``'s host table) are numpy only; the device
derivations (``pair_table``, ``sa_fill``, ``dense_lut``'s extension) run on
torch tensors.
"""
