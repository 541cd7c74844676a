"""ephemeris_explorer_tpu_torch: the PyTorch/CUDA port of ephemeris_explorer_tpu.

The JAX package beside this one is the reference; this package mirrors its
module names so each counterpart is easy to find.  It imports ``torch`` and
never JAX, never sets a global default dtype (every tensor names its
dtype), and takes devices explicitly (a ``device`` argument or the device of
the input tensors).

The hot path on an NVIDIA H100 runs two hand-written CUDA kernels
(``csrc/``), built at first use by :mod:`._build`; on CPU tensors their
wrappers run the plain PyTorch versions of the same arithmetic.
"""

from . import ftime
from .ftime import Duration, Epoch

__version__ = "0.1.0"
