"""Data and tensor parallelism over ``torch.distributed``."""
