"""PyTorch/CUDA port of the guided progressive path tracer.

The JAX package ``mitsuba_path_guiding_tpu`` is the reference; this package
mirrors its module layout so that every function has its counterpart at the
same path (``tests/test_torch_api_surface.py`` holds the port to the
reference's public names and parameters).  Plain tensor code is PyTorch;
the seven Pallas kernels (``gather_rows_t``, ``trace_fused``,
``intersect_tiled``, the pair pipeline's MT and Plücker tiles, the
blocklist and the two-level kernel) and the BVH walk are CUDA kernels
under ``csrc/``, built with nvcc at first use (see ``ops/build.py``).

Entry points take ``device=None``, which means ``"cuda"``: without a card
they raise unless the caller asks for ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from mitsuba_path_guiding_torch.core import math as mmath  # noqa: E402,F401
from mitsuba_path_guiding_torch.core import rng, spectrum, warp  # noqa: E402,F401
