"""spartan_tpu_torch: the PyTorch/CUDA port of ``spartan_tpu``.

A lazy NumPy-like expression DAG (map / map2 / reduce / dot / slice /
loop) over tiled arrays, evaluated eagerly with torch on one device,
with masked arrays, region writes and donation, checkpoints and the
checkpointed loop, the smart-tiling optimizer and redistribution
planner on a logical mesh, host spans and metrics, the explicit SPMD
layer (``shard_map`` bodies with collectives on a logical mesh or over
the ranks of a ``torch.distributed`` group, ``initialize``), and the
Pallas kernels of the JAX package as hand-written CUDA kernels for
Hopper.
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
from .parallel import collectives  # noqa: E402
from .parallel import mesh as _mesh  # noqa: E402
from .parallel.mesh import (StaleMeshError, build_mesh,  # noqa: E402
                            get_default_device, get_mesh,
                            initialize_distributed, mesh_epoch,
                            rebuild_mesh, set_default_device, set_mesh,
                            use_mesh)
from . import obs  # noqa: E402
from .obs import (REGISTRY, Counter, Gauge, Histogram, Registry,  # noqa: E402
                  Span, metrics, span, trace_clear, trace_events,
                  trace_export)
from . import resilience  # noqa: E402
from .resilience.classify import FatalMeshError  # noqa: E402
from .resilience.faults import ChaosPlan, chaos, chaos_clear  # noqa: E402
from .utils import checkpoint, profiling  # noqa: E402
from .utils.config import FLAGS  # noqa: E402

__version__ = "0.1.0"

__all__ = (["DistArray", "SparseDistArray", "MaskedDistArray", "TileExtent",
            "Tiling", "FLAGS", "from_reference", "checkpoint", "resilience",
            "FatalMeshError", "chaos", "chaos_clear", "ChaosPlan",
            "rebuild_mesh", "mesh_epoch", "StaleMeshError",
            "build_mesh", "get_mesh", "set_mesh", "use_mesh",
            "set_default_device", "get_default_device", "initialize",
            "initialize_distributed", "shutdown", "collectives",
            "stencil", "maxpool", "avgpool",
            "obs", "profiling", "metrics", "trace_export", "trace_events",
            "trace_clear", "span", "Span", "REGISTRY", "Registry",
            "Counter", "Gauge", "Histogram"]
           + list(_expr_all))


def initialize(argv=None):
    """Parity with the reference's ``spartan.initialize()``: parse
    ``--flag=value`` arguments into ``FLAGS``, bring up the process
    group when an address or a launcher's environment is present
    (``parallel/mesh.py::initialize_distributed``; nothing otherwise)
    and install the ambient mesh. Returns the arguments no flag took."""
    rest = FLAGS.parse_args(argv)
    _mesh.initialize_distributed()
    _mesh.get_mesh()
    resilience.faults.install_from_flags()
    return rest


def shutdown():
    """Clear the ambient mesh, and destroy the process group when
    ``initialize`` created it."""
    _mesh.shutdown()
