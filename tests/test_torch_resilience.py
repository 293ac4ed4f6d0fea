"""The port's resilience ladder on the CPU, against the JAX package: the
classifier tables, the chaos grammar and its seeded draws, the retry
engine, the OOM ladder, the mesh epoch and ``rebuild_mesh``, and the
sticky-CUDA rule of elastic recovery.

Both packages get the same numpy inputs, the JAX package on its 8-device
CPU mesh (4, 2) and the port on a logical (4, 2) mesh. Tolerances:
classes, fired faults, rung names, grids, retry counts and counter deltas
equal; retried results bit-equal to the clean ones; degraded results
rtol 1e-6 (the JAX package's tolerance at
``tests/test_resilience.py:133``).
"""

import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.expr import base as base_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.resilience import classify as cls_j
from spartan_tpu.resilience import engine as engine_j
from spartan_tpu.resilience import faults as faults_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import classify as cls_t
from spartan_tpu_torch.resilience import elastic as elastic_t
from spartan_tpu_torch.resilience import engine as engine_t
from spartan_tpu_torch.resilience import faults as faults_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

_SAVED = ("retry_backoff_s", "retry_max", "retry_budget", "oom_degrade",
          "resilience", "elastic_recovery", "opt_map_fusion",
          "opt_reduce_fusion", "fault_inject", "fault_seed")


@pytest.fixture(autouse=True)
def _world(mesh2d):
    from spartan_tpu.serve import shutdown_default

    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = [{n: getattr(F, n) for n in _SAVED} for F in (FLAGS_J, FLAGS_T)]
    for F in (FLAGS_J, FLAGS_T):
        F.retry_backoff_s = 0.0
    for mod in (st_j, st_t):
        mod.chaos_clear()
    engine_j.reset()
    engine_t.reset()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2), "cpu")):
        yield
    for mod in (st_j, st_t):
        mod.chaos_clear()
    engine_j.reset()
    engine_t.reset()
    shutdown_default()
    mesh_j.reset_epoch_for_tests()
    mesh_t.reset_epoch_for_tests()
    for F, vals in zip((FLAGS_J, FLAGS_T), saved):
        for n, v in vals.items():
            setattr(F, n, v)
    mesh_t.set_default_device(prev)


def _c(st, name):
    return st.metrics()["counters"].get(name, 0)


def _fresh(st, shape=(16, 16), seed=0):
    a = (np.random.RandomState(seed).rand(*shape).astype(np.float32) + 1.0)
    return a, st.from_numpy(a)


# -- the classifier -----------------------------------------------------------

# every wording of the JAX package's own tables
# (tests/test_resilience.py:48-72 and :588-610), as (factory, expected)
_JAX_TABLE = [
    (lambda m: RuntimeError("UNAVAILABLE: socket closed"), "transient"),
    (lambda m: RuntimeError("DEADLINE_EXCEEDED: operation timed out"),
     "transient"),
    (lambda m: RuntimeError("RESOURCE_EXHAUSTED: Out of memory while "
                            "trying to allocate 1073741824 bytes"), "oom"),
    (lambda m: MemoryError(), "oom"),
    (lambda m: OSError("disk full"), "io"),
    (lambda m: ValueError("bad axis"), "deterministic"),
    (lambda m: RuntimeError("INVALID_ARGUMENT: bad layout"),
     "deterministic"),
    (lambda m: RuntimeError("INTERNAL: compiler bug"), "deterministic"),
    (lambda m: m.InjectedTransientError("x"), "transient"),
    (lambda m: m.InjectedOOMError("x"), "oom"),
    (lambda m: m.InjectedCompileError("x"), "deterministic"),
    (lambda m: m.InjectedCheckpointError("x"), "io"),
    (lambda m: m.InjectedRecoveryError("x"), "transient"),
    (lambda m: RuntimeError("DATA_LOSS: checkpoint shard unrecoverable "
                            "after device failure"), "fatal_mesh"),
    (lambda m: RuntimeError("FAILED_PRECONDITION: client has been "
                            "halted"), "fatal_mesh"),
    (lambda m: RuntimeError("INTERNAL: Device 3 failed: tpu core in bad "
                            "state"), "fatal_mesh"),
    (lambda m: RuntimeError("UNAVAILABLE: device lost"), "transient"),
    (lambda m: m.InjectedDeviceLossError("x"), "fatal_mesh"),
    (lambda m: (st_j if m is faults_j else st_t).FatalMeshError("gone"),
     "fatal_mesh"),
    (lambda m: (st_j if m is faults_j else st_t).StaleMeshError("old"),
     "stale_mesh"),
]


@pytest.mark.parametrize("i", range(len(_JAX_TABLE)))
def test_classifier_tables_agree_with_jax(i):
    make, kind = _JAX_TABLE[i]
    assert cls_j.classify(make(faults_j)) == kind
    assert cls_t.classify(make(faults_t)) == kind


_TORCH_FORMS = [
    (lambda: torch.distributed.DistNetworkError("store gone"), "fatal_mesh"),
    (lambda: torch.distributed.DistBackendError("backend failed"),
     "fatal_mesh"),
    (lambda: RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection "
                          "closed by peer [127.0.0.1]:18347"), "fatal_mesh"),
    (lambda: RuntimeError("[gloo/transport/tcp/pair.cc:598] Read error "
                          "[127.0.0.1]: Connection reset by peer"),
     "fatal_mesh"),
    (lambda: RuntimeError("[gloo/transport/tcp/unbound_buffer.cc:78] Timed "
                          "out waiting 5000ms for recv operation to "
                          "complete"), "fatal_mesh"),
    (lambda: RuntimeError("NCCL error: remote process exited or there was "
                          "a network error"), "fatal_mesh"),
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 80.00 GiB"), "oom"),
    (lambda: RuntimeError("connection reset"), "transient"),
]


@pytest.mark.parametrize("i", range(len(_TORCH_FORMS)))
def test_classifier_torch_peer_loss_forms(i):
    """torch.distributed's peer losses are fatal_mesh (a retry would wait
    on the dead rank); CUDA's OOM stays oom; a bare connection reset,
    not by a peer, stays transient."""
    make, kind = _TORCH_FORMS[i]
    assert cls_t.classify(make()) == kind


# -- chaos --------------------------------------------------------------------

_TOKENS = ["transient@2", "oom@4x3", "slow@1=0.25", "io@0", "compile@0",
           "transient:0.3", "device_loss@2", "device_loss@2#3", "recover@1",
           "slow@3=0.5", "transient@0x10"]


@pytest.mark.parametrize("tok", _TOKENS)
def test_chaos_grammar_roundtrip(tok):
    sj, stt = faults_j.FaultSpec(tok), faults_t.FaultSpec(tok)
    for f in ("kind", "at", "count", "dev", "prob", "dur"):
        assert getattr(stt, f) == getattr(sj, f)
    assert repr(stt) == repr(sj)


@pytest.mark.parametrize("tok,err", [("explode@1", ValueError),
                                     ("transient", ValueError),
                                     ("oom@1#2", ValueError)])
def test_chaos_bad_tokens_raise_like_jax(tok, err):
    for mod in (faults_j, faults_t):
        with pytest.raises(err):
            mod.ChaosPlan(tok, 0)


def test_chaos_sdc_waits_for_integrity():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        faults_t.ChaosPlan("sdc@5", 0)


@pytest.mark.parametrize("seed", [0, 42])
def test_chaos_probabilistic_fires_at_the_same_calls(seed):
    """A seeded plan fires at the same occurrences of each site in both
    packages, whatever the interleaving of sites."""
    sites = ["dispatch", "compile", "checkpoint", "recover"] * 40
    spec = "transient:0.2,io:0.3,recover:0.25,slow:0.1=0"
    out = []
    for mod in (faults_j, faults_t):
        plan = mod.ChaosPlan(spec, seed)
        for s in sites:
            try:
                plan.fire(s)
            except (RuntimeError, OSError):
                pass
        out.append(plan.fired)
    assert out[0] == out[1] and len(out[0]) > 10


def test_chaos_probabilistic_evaluations_fire_alike():
    """Evaluations under a seeded ``transient:0.3`` plan: the same faults
    at the same occurrences, the same retries and the same outcomes in
    both packages."""
    res = []
    for st in (st_j, st_t):
        fired, outs = None, []
        with st.chaos("transient:0.3", seed=3) as plan:
            for i in range(12):
                a, x = _fresh(st, (8, 8 + i % 3), seed=i)
                try:
                    outs.append(np.asarray(((x * 2.0) + 1.0).sum().glom()))
                except RuntimeError:
                    outs.append(None)
            fired = [(f["kind"], f["occurrence"]) for f in plan.fired]
        res.append((fired, outs))
    assert res[0][0] == res[1][0] and res[0][0]
    for a, b in zip(res[0][1], res[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_chaos_installs_from_flags():
    FLAGS_T.fault_inject = "transient@0,oom@1"
    plan = faults_t.install_from_flags()
    assert plan is faults_t.active() and len(plan.specs) == 2
    st_t.chaos_clear()
    FLAGS_T.fault_inject = ""
    assert faults_t.install_from_flags() is None


# -- the retry engine ---------------------------------------------------------


def _run_case(st, mode, spec):
    if mode == "evaluate":
        a, x = _fresh(st, seed=3)
        clean = np.asarray(((x * 2.0 + 1.0).sum(axis=0)).glom())
        with st.chaos(spec):
            _, x2 = _fresh(st, seed=3)
            faulted = np.asarray(((x2 * 2.0 + 1.0).sum(axis=0)).glom())
        return clean, faulted
    a, x = _fresh(st, (8, 8), seed=4)
    clean = np.asarray(st.loop(5, lambda c: c * 1.01 + x,
                               st.from_numpy(a)).glom())
    with st.chaos(spec):
        faulted = np.asarray(st.loop(5, lambda c: c * 1.01 + x,
                                     st.from_numpy(a)).glom())
    return clean, faulted


@pytest.mark.parametrize("mode", ["evaluate", "loop"])
def test_transient_retry_matches_jax(mode):
    deltas = []
    for st in (st_j, st_t):
        r0, v0 = _c(st, "resilience_retries"), _c(st, "resilience_recovered")
        clean, faulted = _run_case(st, mode, "transient@0")
        np.testing.assert_array_equal(clean, faulted)
        deltas.append((_c(st, "resilience_retries") - r0,
                       _c(st, "resilience_recovered") - v0))
    assert deltas[0] == deltas[1] == (1, 1)


def test_retry_record_spans_and_faults():
    _, x = _fresh(st_t, seed=7)
    e = (x * 5.0).sum()
    with st_t.chaos("transient@0"):
        e.glom()
    rec = e._resilience
    assert rec["retries"] == 1
    assert [f["class"] for f in rec["faults"]] == ["transient"]
    names = [s.name for s in st_t.trace_events()]
    assert "retry" in names and "chaos" in names


def test_retry_budget_exhaustion_note():
    notes = []
    for st, F in ((st_j, FLAGS_J), (st_t, FLAGS_T)):
        F.retry_max, F.retry_budget = 3, 1
        _, x = _fresh(st, seed=8)
        with st.chaos("transient@0x10"):
            with pytest.raises(RuntimeError, match="UNAVAILABLE") as ei:
                (x * 7.0).sum().glom()
        notes.append([n for n in ei.value.__notes__ if "budget" in n])
    assert notes[0] and notes[1]
    assert engine_t._last_dump["reason"] == "retry budget exhausted"


def test_retries_exhausted_note():
    for st, F in ((st_j, FLAGS_J), (st_t, FLAGS_T)):
        F.retry_max = 2
        _, x = _fresh(st, seed=9)
        with st.chaos("transient@0x10"):
            with pytest.raises(RuntimeError) as ei:
                (x * 9.0).sum().glom()
        assert any("retry(ies) exhausted" in n for n in ei.value.__notes__)


def test_deterministic_fails_fast_with_plan_note():
    for st in (st_j, st_t):
        r0 = _c(st, "resilience_retries")
        _, x = _fresh(st, (5, 16), seed=10)
        with st.chaos("compile@0"):
            with pytest.raises(RuntimeError, match="INVALID_ARGUMENT") as ei:
                (x * 11.0).sum().glom()
        assert any("deterministic failure" in n and "plan" in n
                   for n in ei.value.__notes__)
        assert _c(st, "resilience_retries") == r0


def test_master_switch_off_propagates_raw():
    for st, F in ((st_j, FLAGS_J), (st_t, FLAGS_T)):
        F.resilience = False
        _, x = _fresh(st, seed=11)
        with st.chaos("transient@0"):
            with pytest.raises(RuntimeError, match="UNAVAILABLE"):
                (x * 13.0).sum().glom()


def test_compile_site_then_dispatch_site():
    """A plan's first run is the ``compile`` seam, later hits of it are
    ``dispatch``, both counting dispatch occurrences (the JAX package's
    executable warmth)."""
    sites = []
    for st in (st_j, st_t):
        with st.chaos("slow:1.0=0") as plan:
            for seed in (12, 13):
                _, x = _fresh(st, (6, 10), seed=seed)
                (x * 3.0 + 2.0).glom()
        sites.append([(f["site"], f["occurrence"]) for f in plan.fired])
    assert sites[0] == sites[1] == [("compile", 0), ("dispatch", 1)]


def test_retry_evaluate_and_the_deprecated_shim():
    from spartan_tpu_torch.utils import recovery

    calls = []
    _, x = _fresh(st_t, seed=14)
    e = x * 2.0
    with st_t.chaos("transient@0x4"):
        FLAGS_T.resilience = False  # every failure reaches the caller's loop
        out = engine_t.retry_evaluate(
            e, retries=5, on_failure=lambda i, exc: calls.append(i))
    np.testing.assert_array_equal(out.glom(), _fresh(st_t, seed=14)[0] * 2.0)
    assert calls == [0, 1, 2, 3]
    with pytest.warns(DeprecationWarning):
        with st_t.chaos("transient@0"):
            recovery.evaluate_with_recovery(_fresh(st_t, seed=15)[1] * 3.0)
    with pytest.raises(ValueError):
        engine_t.retry_evaluate(_BadExpr(), retries=3)


class _BadExpr:
    def evaluate(self):
        raise ValueError("bad shape")


def test_tenant_scope_charges_its_own_account():
    FLAGS_T.retry_budget = 1
    _, x = _fresh(st_t, seed=16)
    with st_t.chaos("transient@0,transient@2"):
        with engine_t.tenant_scope("a"):
            assert engine_t.current_tenant() == "a"
            (x * 17.0).sum().glom()
        _, x2 = _fresh(st_t, seed=16)
        with engine_t.tenant_scope("b"):
            (x2 * 17.0).sum().glom()  # b's budget is its own
    assert engine_t.current_tenant() is None


# -- the OOM ladder -----------------------------------------------------------


@pytest.mark.parametrize("spec,rung", [("oom@0", "finer_tiling"),
                                       ("oom@0x2", "fusion_off"),
                                       ("oom@0x3", "chunked")])
def test_oom_ladder_rungs_match_jax(spec, rung):
    rungs = []
    for st in (st_j, st_t):
        a, x = _fresh(st, seed=17)
        e = x * 2.0 + 1.0
        d0 = _c(st, f"resilience_degrade_{rung}")
        with st.chaos(spec):
            out = np.asarray(e.glom())
        np.testing.assert_allclose(out, a * 2.0 + 1.0, rtol=1e-6)
        assert _c(st, f"resilience_degrade_{rung}") == d0 + 1
        rungs.append(e._resilience["rung"])
    assert rungs == [rung, rung]


def test_oom_ladder_exhausted_on_a_scalar_root():
    for st in (st_j, st_t):
        _, x = _fresh(st, seed=18)
        with st.chaos("oom@0x100"):
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as ei:
                (x * 3.0).sum().glom()
        assert any("ladder exhausted" in n for n in ei.value.__notes__)
    assert engine_t._last_dump["resilience"]["oom_events"] >= 1


def test_degraded_and_normal_plans_never_collide():
    a, x = _fresh(st_t, seed=19)
    expected = (a * 2.0 + 3.0).sum(axis=1)
    plans0 = base_t.plan_cache_size()
    with st_t.chaos("oom@0"):
        e1 = (x * 2.0 + 3.0).sum(axis=1)
        np.testing.assert_allclose(e1.glom(), expected, rtol=1e-6)
    assert base_t.plan_cache_size() == plans0 + 2
    # the rung is on the failed plan's report, which a later hit of the
    # same structure reads
    normal = [p for k, p in base_t._plan_cache.items()
              if k[1][-1] is None and p.report.get("resilience")]
    assert normal[-1].report["resilience"]["rung"] == "finer_tiling"
    _, x2 = _fresh(st_t, seed=19)
    e2 = (x2 * 2.0 + 3.0).sum(axis=1)
    np.testing.assert_allclose(e2.glom(), expected, rtol=1e-6)
    assert base_t.plan_cache_size() == plans0 + 2
    assert getattr(e2, "_resilience", None) is None


def test_degrade_never_mutates_user_exprs():
    _, x = _fresh(st_t, seed=20)
    e = (x * 2.0).sum(axis=0)
    kids = e.children()
    with st_t.chaos("oom@0"):
        e.glom()
    assert e.children() == kids and e._forced_tiling is None


def test_real_oom_error_is_classified_and_degraded():
    """A torch OOM raised inside a run goes to the ladder like an
    injected one."""
    _, x = _fresh(st_t, seed=21)
    e = x * 4.0
    calls = [0]
    orig = base_t._run

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return orig(*a, **k)

    base_t._run = flaky
    try:
        out = e.glom()
    finally:
        base_t._run = orig
    np.testing.assert_array_equal(out, _fresh(st_t, seed=21)[0] * 4.0)
    assert e._resilience["rung"] == "finer_tiling"


# -- the mesh epoch -----------------------------------------------------------


def test_rebuild_grids_match_jax():
    """The same exclusion sequence gives the same survivor grids and
    shape history: excluding 7 from the (4, 2) mesh gives (7, 1), then
    excluding 6 as well gives (3, 2). The port records the pinned
    epoch-0 mesh in its history too; the JAX package records epoch 0
    only for its unpinned default mesh (None here)."""
    out = []
    for st, mesh_mod in ((st_j, mesh_j), (st_t, mesh_t)):
        grids = [dict(mesh_mod.get_mesh().shape)]
        st.rebuild_mesh(exclude_devices=[7])
        grids.append(dict(mesh_mod.get_mesh().shape))
        st.rebuild_mesh(exclude_devices=[6])
        grids.append(dict(mesh_mod.get_mesh().shape))
        out.append((grids, [mesh_mod.mesh_shape_at(e) for e in range(3)],
                    st.mesh_epoch()))
        mesh_mod.reset_epoch_for_tests()
    assert out[0][0] == out[1][0] and out[0][2] == out[1][2] == 2
    assert out[0][1][1:] == out[1][1][1:]
    assert out[1][1][0] == {"x": 4, "y": 2}
    assert out[1][0] == [{"x": 4, "y": 2}, {"x": 7, "y": 1},
                         {"x": 3, "y": 2}]


def test_use_mesh_pin_is_epoch_fenced():
    old = mesh_t.get_mesh()
    with mesh_t.use_mesh(old):
        st_t.rebuild_mesh(exclude_devices=[old.ids[-1]])
        now = mesh_t.get_mesh()
        assert now is not old and len(now.ids) == len(old.ids) - 1
        assert mesh_t.pinned_mesh() is now
    assert mesh_t.get_mesh() is now


def test_group_mesh_is_not_rebuilt(monkeypatch):
    class _Group:
        is_group = True
        ids = (0, 1)

    monkeypatch.setattr(mesh_t, "get_mesh", lambda: _Group())
    with pytest.raises(RuntimeError, match="resumes from its last snapshot"):
        mesh_t.rebuild_mesh(exclude_devices=[1])
    assert st_t.mesh_epoch() == 0


def test_stale_array_raises_naming_every_leaf_then_rehomes():
    a, x = _fresh(st_t, seed=22)
    b, y = _fresh(st_t, seed=23)
    st_t.rebuild_mesh()
    with pytest.raises(st_t.StaleMeshError) as ei:
        (x + y).evaluate()
    assert "rehome" in str(ei.value)
    assert [id(v) for v in ei.value.arrays] == [id(x.value), id(y.value)]
    assert any("stale mesh epoch" in n for n in ei.value.__notes__)
    assert elastic_t.rehome(ei.value.arrays) == 2
    np.testing.assert_array_equal((x + y).glom(), a + b)


def test_epoch_keyed_plans_never_collide_and_evict():
    _, x = _fresh(st_t, seed=24)
    (x + 5.0).evaluate()
    k0, _ = base_t.plan_signature(x + 5.0)
    st_t.rebuild_mesh()
    _, x2 = _fresh(st_t, seed=24)
    k1, _ = base_t.plan_signature(x2 + 5.0)
    assert k0 != k1 and k0[2][0][0] + 1 == k1[2][0][0]
    assert base_t.lookup_plan(k1) is None
    assert base_t.lookup_plan(k0) is not None
    assert base_t.evict_stale_plans() >= 1
    assert base_t.lookup_plan(k0) is None


def test_device_loss_evaluate_rebuilds_like_jax():
    out = []
    for st, mesh_mod in ((st_j, mesh_j), (st_t, mesh_t)):
        r0 = _c(st, "elastic_recoveries")
        _, x = _fresh(st, seed=25)
        with st.chaos("device_loss@0"):
            with pytest.raises(st.FatalMeshError):
                (x * 2.0).sum().evaluate()
        a2, x2 = _fresh(st, seed=25)
        np.testing.assert_allclose(np.asarray((x2 * 2.0).sum().glom()),
                                   (a2 * 2.0).sum(), rtol=1e-5)
        out.append((st.mesh_epoch(), dict(mesh_mod.get_mesh().shape),
                    _c(st, "elastic_recoveries") - r0))
    assert out[0] == out[1] == (1, {"x": 7, "y": 1}, 1)


def test_device_loss_with_elastic_off_keeps_the_epoch():
    FLAGS_T.elastic_recovery = False
    _, x = _fresh(st_t, seed=26)
    with st_t.chaos("device_loss@0"):
        with pytest.raises(RuntimeError) as ei:
            (x + 1.0).evaluate()
    assert "DATA_LOSS" in str(ei.value) and ei.value.failed_devices == (7,)
    assert cls_t.classify(ei.value) == "fatal_mesh"
    assert st_t.mesh_epoch() == 0


def test_second_failure_for_the_same_loss_is_a_noop():
    with st_t.chaos("device_loss@0"):
        with pytest.raises(st_t.FatalMeshError) as ei:
            (_fresh(st_t, seed=27)[1] * 2.0).sum().evaluate()
    r0 = _c(st_t, "elastic_recoveries")
    m = elastic_t.on_fatal_mesh(ei.value.__cause__ or ei.value)
    assert m is mesh_t.get_mesh() and st_t.mesh_epoch() == 1
    assert _c(st_t, "elastic_recoveries") == r0


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure"])
def test_sticky_cuda_error_rebuilds_nothing(msg):
    """Every logical position shares the card's one CUDA context, so a
    sticky error raises FatalMeshError with no epoch bump and the note
    that resume= in a new process recovers."""
    stub = RuntimeError(msg + " on device 3")
    with pytest.raises(st_t.FatalMeshError) as ei:
        elastic_t.on_fatal_mesh(stub)
    assert st_t.mesh_epoch() == 0
    assert dict(mesh_t.get_mesh().shape) == {"x": 4, "y": 2}
    assert any("resume" in n and "new process" in n
               for n in ei.value.__notes__)
    # and through the engine, from inside an evaluation
    _, x = _fresh(st_t, seed=28)
    orig = base_t._run

    def sticky(*a, **k):
        raise RuntimeError(msg)

    base_t._run = sticky
    try:
        with pytest.raises(st_t.FatalMeshError):
            (x * 2.0).evaluate()
    finally:
        base_t._run = orig
    assert st_t.mesh_epoch() == 0


def test_unattributed_loss_rebuilds_nothing():
    with pytest.raises(st_t.FatalMeshError) as ei:
        elastic_t.on_fatal_mesh(RuntimeError("DATA_LOSS: shard gone"))
    assert st_t.mesh_epoch() == 0
    assert any("names no logical position" in n for n in ei.value.__notes__)
    assert elastic_t.infer_failed_devices(
        RuntimeError("DATA_LOSS: shard gone")) == [7]
    assert elastic_t.infer_failed_devices(
        RuntimeError("device 3 halted")) == [3]


def test_quarantine_device_is_a_planned_idempotent_rebuild():
    """The planned eviction of a position (the integrity sentinel's
    remedy): the same rebuild and eviction without an exception, the
    JAX package's grid, and a no-op when repeated."""
    grids = []
    for st, mesh_mod, elastic in ((st_j, mesh_j, None),
                                  (st_t, mesh_t, elastic_t)):
        if elastic is None:
            from spartan_tpu.resilience import elastic
        q0 = _c(st, "elastic_quarantines")
        m = elastic.quarantine_device(5, reason="test")
        again = elastic.quarantine_device(5)
        assert again is mesh_mod.get_mesh() and st.mesh_epoch() == 1
        assert _c(st, "elastic_quarantines") == q0 + 1
        grids.append(dict(m.shape))
    assert grids[0] == grids[1] == {"x": 7, "y": 1}
    assert 5 not in mesh_t.get_mesh().ids
