"""Collectives and pipeline parallelism over ``torch.distributed``."""
