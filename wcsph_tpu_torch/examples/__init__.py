"""The port's runnable entry points, ``python -m wcsph_tpu_torch.examples.<name>``
from the repository root: ``sample_boundary``, ``run_mesh_scene``,
``run_showcase``, ``run_dam_break`` and ``run_live``, with the arguments and
output file names of the JAX package's ``examples/*.py``.  Each runs on the
card unless ``--device cpu`` is passed."""
