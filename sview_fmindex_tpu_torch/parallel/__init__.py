"""parallel layer of the PyTorch port (mirrors sview_fmindex_tpu.parallel):
one process per device over ``torch.distributed``."""
