"""repro_torch.launch — entry points (``serve --mode spmv``)."""
