"""repro_torch.data — the deterministic token pipeline and the synthetic
matrix generators (numpy)."""
from .pipeline import TokenPipeline, make_batch_iterator
from . import matrices

__all__ = ["TokenPipeline", "make_batch_iterator", "matrices"]
