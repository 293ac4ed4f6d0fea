"""Signature-level request coalescing: many clients, one walk (port of
``spartan_tpu/serve/coalesce.py``).

Requests whose raw-DAG signature matches (the plan-cache key,
``expr/base.plan_signature``) within the batching window share one cached
plan and run as one batched walk along a new leading client axis, the
DrJAX vmap-over-clients construction. Two batching modes:

* ``vmap`` (default) — ``torch.func.vmap`` over the plan's walk
  (``plan.dag.lower`` on an env seeded with the leaves). A leaf every
  request shares goes in once, with ``in_dims=None``; the others are
  stacked. Work on unbatched tensors runs once under vmap, so a shared
  sub-DAG (the ``(x + y).sum()`` of a ``(x + y).sum() * s`` batch) runs
  once per batch, as XLA runs it once in the JAX package's batched
  program; elementwise chains run one wider kernel, and the k-means pass
  reaches its kernel through the operator's batching rule
  (``kernels/kmeans.py``). A batched scalar leaf is stacked on the
  mesh's device: under vmap a stacked CPU scalar would meet a CUDA
  operand as a 1-d tensor.
* ``unroll`` — the walk replayed once per client inside one
  ``launch_guard``: bit-equal to solo by construction. The fallback when
  a plan's walk cannot be vmapped — a lowering that reads the host
  (``.item()``, ``.tolist()``, shapes that depend on data), writes in
  place into an unbatched buffer, or a walk on a group mesh (its
  collectives pair across ranks): a DETERMINISTIC failure of the vmap
  walk demotes the plan to ``unroll``, and a second one to ``off``
  (coalescing disabled for that plan).

Either way the B outputs are split inside the call, one result per
client. Batched scalars aside, a vmap walk is bit-equal to the solo
walks where each op's batched kernel computes each element as the solo
kernel does — the elementwise ops, the reductions over unbatched inputs
and the k-means pass do. One known exception: torch divides a CUDA
tensor by a CPU scalar as a product with its reciprocal, and by a
batched (device) scalar as a true division, so ``x / s`` with a
per-request ``s`` may differ from solo in the last bit.

The vmap walk is keyed into the plan's variant cache
(``plan.key + ('serve', B, mode, shared)``, ``base.cached_executable``)
so it is built once and evicted with its plan; the unroll form needs no
variant. The batch is recorded on the plan report: a plan-cache hit's
``st.explain`` names the coalesced batch.

Under ``FLAGS.audit_numerics`` a batch probes each client's values as
its solo walk would: the JAX package's batched program calls its probe
callbacks once per client (``jax.debug.callback`` unbatches under vmap);
the port's probes read values on the host, so an audited batch replays
the walk per client with the probe session open (the unroll form),
whatever the plan's mode. Like the JAX package's batched program, a
batch runs no integrity re-walk, no sampled profile and no ledger row:
those ride the solo walk (``expr/base._run``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..expr import base
from ..obs import numerics as numerics_mod
from ..obs.explain import key_hash
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..resilience import classify as cls
from ..resilience import faults as faults_mod
from ..utils import profiling as prof
from ..utils.config import FLAGS

FLAGS.define_str(
    "serve_coalesce_mode", "vmap",
    "Leading-axis batching mode for coalesced requests: 'vmap' (one "
    "torch.func.vmap walk; auto-demotes per plan to 'unroll' on a "
    "deterministic vmap failure) or 'unroll' (the walk replayed per "
    "client inside one launch guard; bit-identical to solo by "
    "construction).")

# per-plan mode overrides learned from deterministic batch failures:
# plan.key -> 'unroll' | 'off'. Guarded by its own lock; never held
# while walking.
_mode_lock = threading.Lock()
_mode_override: Dict[Tuple, str] = {}


def reset_modes() -> None:
    """Forget learned per-plan demotions (test isolation)."""
    with _mode_lock:
        _mode_override.clear()


def mode_for(plan: Any) -> str:
    """'vmap' / 'unroll' / 'off' for this plan."""
    with _mode_lock:
        override = _mode_override.get(plan.key)
    if override is not None:
        return override
    mode = FLAGS.serve_coalesce_mode
    return mode if mode in ("vmap", "unroll") else "vmap"


def demote(plan: Any) -> str:
    """Walk the plan one rung down after a deterministic batched
    failure: vmap -> unroll -> off. Returns the new mode."""
    with _mode_lock:
        cur = _mode_override.get(plan.key)
        if cur is None and FLAGS.serve_coalesce_mode == "unroll":
            cur = "unroll"
        new = "unroll" if cur is None else "off"
        _mode_override[plan.key] = new
    return new


def _walk_fn(plan: Any) -> Callable:
    """The plan's walk on a logical mesh as a function of its seeds (in
    ``plan.leaf_ids`` order), freeing interior values at their last
    consumer as ``_run``'s walk does; leaves are never freed."""
    leaf_ids = plan.leaf_ids
    free = plan.release if base.FREE_AT_LAST_USE else None

    def walk(*args: Any) -> Any:
        seeds = zip(leaf_ids, args)
        env = (dict(seeds) if free is None
               else base._FreeingEnv(seeds, free[1], free[0]))
        return plan.dag.lower(env)

    return walk


def _stack(col: List[Any], dev: torch.device) -> Any:
    """One batched seed: the clients' tensors stacked on ``dev``. The
    per-request scalars arrive as 0-d CPU tensors; on the card their
    stack goes up from page-locked memory without a synchronise (a
    pageable copy would wait for the work already queued on the
    stream, the previous batch's kernels)."""
    t = torch.stack(col)
    if t.device.type == dev.type:
        return t
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _make_batched(plan: Any, B: int, nargs: int,
                  shared: Tuple[bool, ...], dev: torch.device) -> Callable:
    """The vmap walk. ``shared[j]`` marks a seed position where every
    request passes the IDENTICAL tensor (requests over the same model or
    dataset arrays differing only in their own inputs): it is passed
    ONCE and vmapped with ``in_dims=None``, so the walk never copies a
    shared leaf into a B-times larger stacked tensor. The flat argument
    list is position-major: one entry for a shared position, B
    otherwise. Returns a B-tuple of per-request outputs."""
    walk = _walk_fn(plan)
    in_dims = tuple(None if s else 0 for s in shared)

    def batched(*flat: Any) -> Tuple[Any, ...]:
        cols: List[Any] = []
        i = 0
        for j in range(nargs):
            if shared[j]:
                cols.append(flat[i])
                i += 1
            else:
                cols.append(list(flat[i:i + B]))
                i += B
        if all(shared):
            # a degenerate batch: every request is the same walk
            return (walk(*cols),) * B
        stacked = [c if s else _stack(c, dev) for s, c in zip(shared, cols)]
        outs = torch.func.vmap(walk, in_dims=in_dims)(*stacked)
        if isinstance(outs, tuple):
            return tuple(tuple(o[i] for o in outs) for i in range(B))
        return tuple(outs[i] for i in range(B))

    return batched


def _replay(plan: Any, requests: List[Any], mesh, probe: bool) -> List[Any]:
    """The unroll form: each client's walk, one after another (on a
    group mesh every rank walks the same batch in the same order, so the
    collectives pair). With ``probe`` each walk runs under the probe
    session, leaves first, as ``_run`` probes a solo walk."""
    outs = []
    for r in requests:
        leaves = [r.leaves[i] for i in plan.arg_order]
        env = base.walk_env(plan, leaves, mesh)
        if not probe:
            outs.append(plan.dag.lower_local(env) if mesh.is_group
                        else plan.dag.lower(env))
            continue
        with numerics_mod.probe_session(mesh):
            for lid, leaf in zip(plan.leaf_ids, leaves):
                numerics_mod.probe(leaf, env[lid], kind="leaf")
            outs.append(plan.dag.lower_local(env) if mesh.is_group
                        else plan.dag.lower(env))
    return outs


def _seeds(plan: Any, requests: List[Any]
           ) -> Tuple[Tuple[bool, ...], List[Any]]:
    """(shared, flat) of a vmap batch: each request's seeds, a position
    passed once where every request holds the same tensor (a scalar
    leaf, a fresh 0-d tensor per request, where every request holds the
    same value)."""
    order = plan.arg_order
    per_req = [base.leaf_args(r.leaves, order) for r in requests]
    first, head = per_req[0], requests[0].leaves
    shared = []
    for j, i in enumerate(order):
        if isinstance(head[i], base.ScalarExpr):
            v = head[i].pyvalue
            shared.append(all(type(r.leaves[i].pyvalue) is type(v)
                              and r.leaves[i].pyvalue == v
                              for r in requests[1:]))
        else:
            shared.append(all(a[j] is first[j] for a in per_req[1:]))
    flat: List[Any] = []
    for j, sh in enumerate(shared):
        if sh:
            flat.append(first[j])
        else:
            flat.extend(a[j] for a in per_req)
    return tuple(shared), flat


def dispatch_batch(plan: Any, requests: List[Any], mesh) -> List[Any]:
    """One coalesced walk for ``requests`` (all sharing ``plan``'s
    signature): gather each request's seeds, run the batched walk, wrap
    each request's outputs and seed its expr's result cache. Raises on
    failure: the engine falls back to solo walks (where the resilience
    policy engine handles classification, per-tenant budgets and
    retries)."""
    B = len(requests)
    mode = mode_for(plan)
    if mode == "off":
        raise RuntimeError("coalescing disabled for this plan")
    if mode == "vmap" and mesh.is_group:
        # deterministic: the ladder demotes the plan, never retries it
        raise RuntimeError(
            "vmap coalescing cannot batch a walk on a group mesh: its "
            "collectives pair calls across ranks per client")
    audit = numerics_mod._AUDIT_FLAG._value
    if any(base._leaf_array(r.leaves[i]) is not None
           and base._leaf_array(r.leaves[i])._donate_next
           for r in requests for i in plan.arg_order):
        # engine routing bug: donating requests are solo
        raise RuntimeError("donating request reached the coalescer")

    ex = None
    with prof.phase("build"):
        if mode == "vmap" and not audit:
            shared, flat = _seeds(plan, requests)
            ex = base.cached_executable(
                plan.key + ("serve", B, mode, shared),
                lambda: _make_batched(plan, B, len(plan.arg_order), shared,
                                      mesh.device))
        else:
            for r in requests:
                base._check_epochs(r.leaves, plan.arg_order)

    phase_name = "compile" if ex is not None and not ex.warm else "dispatch"
    with prof.span("serve_batch", batch=B, mode=mode,
                   plan=key_hash(plan.key)):
        with prof.phase("dispatch"):
            # the same watchdog and chaos seams as expr/base._dispatch: a
            # hung batched walk dumps in-flight forensics, and an
            # installed chaos plan fires BEFORE the walk runs
            with numerics_mod.watchdog(phase_name, plan.report):
                if faults_mod._ACTIVE is not None:
                    faults_mod.fire(phase_name)
                with base.launch_guard(mesh):
                    outs = (ex.fn(*flat) if ex is not None
                            else _replay(plan, requests, mesh, audit))
    if ex is not None:
        ex.warm = True

    with prof.phase("build"):  # ONE timed phase for the whole batch
        results = [base._wrap_result(r.expr, plan, o, mesh)
                   for r, o in zip(requests, outs)]
    if numerics_mod._WATCHPOINTS:
        numerics_mod.poll_watchpoints()

    # coalesced requests count as plan hits (the plan WAS reused), so
    # hit-rate views stay honest
    prof.count("evaluations", B)
    prof.count("plan_hits", B)
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "serve_coalesced_requests",
            "requests served through a coalesced batch").inc(B)
        REGISTRY.counter(
            "serve_coalesced_batches",
            "coalesced batched walks").inc()
        REGISTRY.histogram(
            "serve:batch_size",
            "clients per coalesced walk").observe(float(B))
    if plan.report is not None:
        sv = plan.report.setdefault(
            "serve", {"batches": 0, "requests": 0, "last_batch": None,
                      "mode": mode})
        sv["batches"] += 1
        sv["requests"] += B
        sv["last_batch"] = B
        sv["mode"] = mode
    return results


def classify_batch_failure(exc: BaseException, plan: Any) -> str:
    """Engine hook after a failed batched walk: deterministic failures
    demote the plan's batching mode (a walk that cannot be vmapped never
    will be); transient/oom/io leave the mode alone — the solo
    fallback's resilience engine owns those."""
    kind = cls.classify(exc)
    if kind == cls.DETERMINISTIC:
        new = demote(plan)
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "serve_mode_demotions",
                "plans demoted vmap->unroll->off after deterministic "
                "batched failures").inc()
        return new
    return mode_for(plan)
