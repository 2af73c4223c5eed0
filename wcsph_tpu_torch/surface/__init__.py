"""Surface reconstruction (port of ``wcsph_tpu/surface``): the scalar field
at a refinement of the grid's cells, plain or with Yu & Turk anisotropic
kernels, then marching cubes on the host or on the card."""
