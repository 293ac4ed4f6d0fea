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
from .analysis import PlanAudit, audit_plan, check, lint  # noqa: E402
from .obs import (REGISTRY, AuditReport, CalibrationProfile,  # noqa: E402
                  Counter, DeviceProfile, ExplainReport, Gauge, Histogram,
                  Registry, SkewReport, Span, Watchpoint, audit,
                  dump_crash, explain,
                  fit_profile, load_profile, loop_health, metrics,
                  profile_export, save_profile, span, trace_clear,
                  trace_events, trace_export, unwatch, watch)
from .obs import fleet_status, status  # noqa: E402
from .expr.base import clear_compile_cache, compile_cache_size  # noqa: E402
from . import persist  # noqa: E402
from . import resilience  # noqa: E402
from .resilience.classify import FatalMeshError  # noqa: E402
from .resilience.faults import ChaosPlan, chaos, chaos_clear  # noqa: E402
from .resilience.integrity import IntegrityError  # noqa: E402
from . import serve  # noqa: E402
from .serve import (Backpressure, DeadlineExceeded, EvalFuture,  # noqa: E402
                    MeshReconfiguring, ServeEngine, evaluate_async)
from .utils import checkpoint, profiling  # noqa: E402
from .utils.config import FLAGS  # noqa: E402

__version__ = "0.1.0"

__all__ = (["DistArray", "SparseDistArray", "MaskedDistArray", "TileExtent",
            "Tiling", "FLAGS", "from_reference", "checkpoint", "resilience",
            "FatalMeshError", "IntegrityError", "chaos", "chaos_clear",
            "ChaosPlan",
            "rebuild_mesh", "mesh_epoch", "StaleMeshError",
            "build_mesh", "get_mesh", "set_mesh", "use_mesh",
            "set_default_device", "get_default_device", "initialize",
            "initialize_distributed", "shutdown", "status",
            "fleet_status", "compile_cache_size", "clear_compile_cache",
            "collectives",
            "stencil", "maxpool", "avgpool",
            "obs", "persist", "profiling", "metrics", "trace_export",
            "trace_events",
            "trace_clear", "span", "Span", "REGISTRY", "Registry",
            "Counter", "Gauge", "Histogram", "check", "lint", "audit_plan",
            "PlanAudit", "explain",
            "ExplainReport", "ledger", "CalibrationProfile", "fit_profile",
            "save_profile", "load_profile", "profile", "profile_export",
            "DeviceProfile", "audit", "AuditReport", "watch", "unwatch",
            "Watchpoint", "loop_health", "dump_crash", "flightrec",
            "skew", "SkewReport", "serve", "ServeEngine", "EvalFuture",
            "evaluate_async", "Backpressure", "DeadlineExceeded",
            "MeshReconfiguring"]
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


def ledger(validate=False):
    """The cost ledger: per-plan predicted-vs-measured ratios of the
    tiling DP, per-model aggregates and drift counts, and the active
    calibration state (``obs/ledger.snapshot``)."""
    return obs.ledger_snapshot(validate=validate)


def profile(expr, tier=None, reps=None):
    """Device-time attribution: one profiled walk of ``expr``'s plan,
    per-expr-node device seconds keyed by each node's structural
    digest, next to the tiling DP's modeled cost. ``tier``: 'auto'
    (default) tries the ``torch.profiler`` capture and falls back to
    replay; 'capture' / 'replay' force one. Continuous sampling:
    ``FLAGS.profile_sample_every = N``."""
    return obs.profile.profile(expr, tier=tier, reps=reps)


def flightrec(limit=None):
    """The serve path's flight recorder: recent per-request events
    (submit -> queue -> coalesce -> dispatch -> resolve -> fetch),
    reconstructed request timelines, and per-tenant latency
    decomposition histograms."""
    return obs.flightrec(limit=limit)


def skew(expr, tier=None, reps=None):
    """Shard-level skew report: per-position time skew with a collective
    wait decomposition, per-block data skew over the expression's
    leaves, and an advisory re-tiling when the imbalance ratio exceeds
    ``FLAGS.skew_warn_ratio`` (report-only)."""
    return obs.skew.skew(expr, tier=tier, reps=reps)
