"""Multi-GPU slab decomposition (port of ``wcsph_tpu/parallel/``)."""
