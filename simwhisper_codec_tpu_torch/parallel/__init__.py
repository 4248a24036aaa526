"""Data parallelism over ``torch.distributed``."""
