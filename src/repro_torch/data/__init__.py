"""repro_torch.data — synthetic matrix generators (numpy)."""
from . import matrices

__all__ = ["matrices"]
