"""spartan_tpu_torch: the PyTorch/CUDA port of ``spartan_tpu``.

A lazy NumPy-like expression DAG (map / map2 / reduce / dot / slice /
loop) over tiled arrays, evaluated eagerly with torch on one device,
with masked arrays, region writes and donation, checkpoints and the
checkpointed loop, and the Pallas kernels of the JAX package as
hand-written CUDA kernels for Hopper.
This package imports torch and numpy only: never jax, never
``spartan_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU::

    import spartan_tpu_torch as st
    st.set_default_device("cpu")      # or device="cpu" per call
    x = st.from_numpy(np.ones((4, 4), np.float32))
    print(((x + x) * 3.0).sum().glom())
"""

import torch

# The JAX package multiplies at precision="highest" on every path this
# package carries (examples/kmeans.py, kernels/kmeans.py): float32
# products must not round through TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .array.distarray import DistArray, from_reference  # noqa: E402
from .array.extent import TileExtent  # noqa: E402
from .array.masked import MaskedDistArray  # noqa: E402
from .array.sparse import SparseDistArray  # noqa: E402
from .array.tiling import Tiling  # noqa: E402
from .expr import *  # noqa: F401,F403,E402
from .expr import __all__ as _expr_all  # noqa: E402
from .ops.stencil import avgpool, maxpool, stencil  # noqa: E402
from .parallel.mesh import (build_mesh, get_default_device,  # noqa: E402
                            get_mesh, set_default_device, set_mesh,
                            use_mesh)
from . import resilience  # noqa: E402
from .resilience.classify import FatalMeshError  # noqa: E402
from .utils import checkpoint  # noqa: E402
from .utils.config import FLAGS  # noqa: E402

__version__ = "0.1.0"

__all__ = (["DistArray", "SparseDistArray", "MaskedDistArray", "TileExtent",
            "Tiling", "FLAGS", "from_reference", "checkpoint", "resilience",
            "FatalMeshError",
            "build_mesh", "get_mesh", "set_mesh", "use_mesh",
            "set_default_device", "get_default_device",
            "stencil", "maxpool", "avgpool"]
           + list(_expr_all))
