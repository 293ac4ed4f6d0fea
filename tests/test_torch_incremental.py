"""The port's delta-aware incremental engine (``expr/incremental.py``),
the lineage of ``DistArray.update`` and the update stash, on the CPU.

Each case of ``tests/test_incremental.py`` has its counterpart here, run
on the same streams at the same sizes through both packages, on the
JAX package's 4x2 and 8x1 CPU meshes and the port's logical meshes of
the same shapes. Every case holds the port to three things:

* each port result is bit-equal to the port's own flag-off recompute of
  the same state (the engine's contract);
* the port's ``incremental_*`` counter deltas, and the mode and fallback
  reason of each warm evaluate, equal the JAX package's on the same
  stream;
* the port's values agree with the JAX package's: elementwise streams to
  1e-6 relative, reductions and products (which sum in another order)
  to 1e-5.

The exceptions, stated per case: ``test_matmul_row_delta_bitequal`` is
red in the JAX package (ROADMAP C1: XLA's CPU GEMM does not give the
restricted rows the full product's bits), and the column product of
``test_dot_column_delta_bitequal`` misses them on 8x1, so there the JAX
side is not held to its own flag-off run; the port holds its own. The memory governor's
share differs by design (the port's logical mesh is one card, so the
whole cache is charged to it; the JAX package divides over its chips).
The JAX package's gather concern (a traced-start slice of a sharded
axis) does not exist on a logical mesh, but the port widens a restricted
product's window to ``incremental.order_granule`` (256 on a one-thread
CPU) to keep the full product's reduction order, so at these sizes a
restricted product spans the whole operand.
"""

import re
import types

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1)]
ELEM, SUM = 1e-6, 1e-5
_COUNTERS = ("incremental_hits", "incremental_fallbacks",
             "incremental_recomputed_tiles", "incremental_evictions")


def _pkg(name):
    """The modules a case touches, for one package."""
    import importlib

    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    base = m("expr.base")
    return types.SimpleNamespace(
        name=name, st=st_j if name == "spartan_tpu" else st_t,
        da=m("array.distarray"), Lineage=m("array.distarray").Lineage,
        MUTLOG_MAX=m("array.distarray")._MUTLOG_MAX,
        TileExtent=m("array.extent").TileExtent, base=base,
        evaluate=base.evaluate, lazify=base.lazify,
        inc=m("expr.incremental"), mesh=m("parallel.mesh"),
        prof=m("utils.profiling"), FLAGS=m("utils.config").FLAGS,
        loop=m("expr.loop").loop, shuffle=m("expr.shuffle").shuffle,
        DotExpr=m("expr.dot").DotExpr, memory=m("resilience.memory"))


J = _pkg("spartan_tpu")
T = _pkg("spartan_tpu_torch")
_SAVED = ("incremental", "result_cache_bytes", "incremental_max_dirty_frac",
          "retry_max", "retry_backoff_s")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


class _Obs:
    """What one package's run of a case shows: facts that must equal the
    other package's, values compared within a tolerance, and the
    bit-equality of each result with the package's own flag-off run."""

    def __init__(self, P):
        self.P = P
        self.facts, self.values, self.bitequal = [], [], []

    def fact(self, *xs):
        self.facts.append(xs)

    def value(self, a):
        self.values.append(np.asarray(a))

    def mode(self, expr):
        """The mode and fallback reason the last warm evaluate of
        ``expr``'s plan recorded."""
        P = self.P
        plan = P.base.lookup_plan(P.base.plan_signature(expr)[0])
        inc = (plan.report or {}).get("incremental") or {}
        self.fact("mode", inc.get("mode"), inc.get("fallback"))

    def result(self, got, build, *np_args):
        """``got`` against the package's own flag-off recompute of the
        same data (``_full_reference``), and its values on record."""
        ref = _full_reference(self.P, build, *np_args)
        self.bitequal.append(bool(np.array_equal(got, ref)))
        self.value(got)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _arr(P, a):
    return P.da.from_numpy(np.ascontiguousarray(a))


def _full_reference(P, build, *np_args):
    """The oracle: the same DAG over FRESH arrays with the engine off."""
    prev = P.FLAGS.incremental
    P.FLAGS.incremental = False
    try:
        return P.evaluate(build(*[_arr(P, a) for a in np_args])).glom()
    finally:
        P.FLAGS.incremental = prev


def _counters(P):
    c = P.prof.counters()
    return {k: c.get(k, 0) for k in _COUNTERS}


def _run(P, case, mesh, monkeypatch):
    ctx = (mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh))
           if P is J else mesh_t.use_mesh(mesh_t.build_mesh(mesh)))
    saved = {n: getattr(P.FLAGS, n) for n in _SAVED}
    P.FLAGS.incremental = True
    P.FLAGS.retry_backoff_s = 0.0
    P.inc.clear()
    P.st.chaos_clear()
    obs = _Obs(P)
    try:
        with ctx, monkeypatch.context() as mp:
            c0 = _counters(P)
            case(P, obs, mp)
            c1 = _counters(P)
    finally:
        P.st.chaos_clear()
        P.inc.clear()
        for n, v in saved.items():
            setattr(P.FLAGS, n, v)
    obs.counters = {k: c1[k] - c0[k] for k in _COUNTERS}
    return obs


def _both(case, mesh, monkeypatch, rtol=ELEM, jax_bitequal=True):
    oj = _run(J, case, mesh, monkeypatch)
    ot = _run(T, case, mesh, monkeypatch)
    assert all(ot.bitequal), ot.bitequal
    if jax_bitequal:
        assert all(oj.bitequal), oj.bitequal
    assert ot.counters == oj.counters
    assert ot.facts == oj.facts
    assert len(ot.values) == len(oj.values)
    for got, want in zip(ot.values, oj.values):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    return oj, ot


# -- the lineage log (array/distarray.py) --------------------------------


def _lineage_bbox(P, o, mp):
    shape = (16, 16)
    E = P.TileExtent
    lin = P.Lineage()
    v0 = lin.latest
    lin.note(E((0, 0), (2, 2), shape))
    lin.note(E((4, 4), (6, 8), shape))
    box = lin.dirty_between(v0, lin.latest, shape)
    o.fact(tuple(box.ul), tuple(box.lr))
    o.fact(lin.dirty_between(lin.latest, lin.latest, shape))
    lin.note(None)
    o.fact(lin.dirty_between(v0, lin.latest, shape))
    lin2 = P.Lineage()
    for _ in range(P.MUTLOG_MAX + 5):
        lin2.note(E((0, 0), (1, 1), shape))
    o.fact(lin2.dirty_between(0, lin2.latest, shape), len(lin2.log))
    lin3 = P.Lineage()
    first = lin3.note(E((0, 0), (1, 1), shape))
    for _ in range(P.MUTLOG_MAX):
        lin3.note(E((2, 2), (3, 3), shape))
    o.fact(lin3.dirty_between(first - 1, lin3.latest, shape))


@pytest.mark.parametrize("mesh", MESHES)
def test_lineage_bbox_and_overflow(mesh, monkeypatch):
    _, ot = _both(_lineage_bbox, mesh, monkeypatch)
    assert ot.facts[0] == ((0, 0), (6, 8))
    assert ot.facts[2] == (None,) and ot.facts[3][0] is None


def _update_threads(P, o, mp):
    a_np = _rand((16, 16))
    a = _arr(P, a_np)
    b = a.update((slice(2, 4), slice(0, 16)),
                 np.zeros((2, 16), np.float32))
    o.fact(b is not a, b._lineage is a._lineage,
           b._version == a._version + 1)
    box = b._lineage.dirty_between(a._version, b._version, a.shape)
    o.fact(tuple(box.ul), tuple(box.lr))
    o.value(b.glom())
    o.bitequal.append(bool(np.array_equal(a.glom(), a_np)))


@pytest.mark.parametrize("mesh", MESHES)
def test_update_threads_lineage_and_values(mesh, monkeypatch):
    oj, ot = _both(_update_threads, mesh, monkeypatch, rtol=0.0)
    assert ot.facts[0] == (True, True, True)
    assert ot.facts[1] == ((2, 0), (4, 16))


# -- warm-path behavior ---------------------------------------------------


def _all_clean(P, o, mp):
    a = _arr(P, _rand((32, 32)))
    r1 = P.evaluate(P.lazify(a) * 2.0 + 1.0)
    r2 = P.evaluate(P.lazify(a) * 2.0 + 1.0)
    o.fact(r2 is r1)
    o.mode(P.lazify(a) * 2.0 + 1.0)


@pytest.mark.parametrize("mesh", MESHES)
def test_all_clean_warm_evaluate_is_zero_dispatch(mesh, monkeypatch):
    _, ot = _both(_all_clean, mesh, monkeypatch)
    assert ot.facts[0] == (True,) and ot.counters["incremental_hits"] == 1


def _map_delta(P, o, mp):
    a_np = _rand((64, 64))
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 3.0 + 0.5

    P.evaluate(build(a))
    a2 = a.update((slice(10, 12), slice(0, 64)), 7.0)
    a2_np = a_np.copy()
    a2_np[10:12] = 7.0
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_map_delta_is_incremental_and_bitequal(mesh, monkeypatch):
    _, ot = _both(_map_delta, mesh, monkeypatch)
    assert ot.counters["incremental_hits"] == 1
    assert ot.counters["incremental_recomputed_tiles"] > 0
    assert ot.counters["incremental_fallbacks"] == 0


def _overlapping(P, o, mp):
    a_np = _rand((64, 64), seed=3)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) + 1.0

    P.evaluate(build(a))
    a2 = a.update((slice(4, 8), slice(0, 64)), 1.0)
    a3 = a2.update((slice(6, 10), slice(0, 64)), 2.0)
    ref = a_np.copy()
    ref[4:8] = 1.0
    ref[6:10] = 2.0
    r = P.evaluate(build(a3))
    o.mode(build(a3))
    o.result(r.glom(), build, ref)


@pytest.mark.parametrize("mesh", MESHES)
def test_overlapping_updates_coalesce_to_bbox(mesh, monkeypatch):
    _, ot = _both(_overlapping, mesh, monkeypatch)
    assert ot.counters["incremental_hits"] == 1


def _inc_line(P, expr):
    rep = str(P.st.explain(expr))
    return [ln.strip() for ln in rep.splitlines()
            if ln.strip().startswith("incremental:")]


def _full_overwrite(P, o, mp):
    a_np = _rand((32, 32), seed=1)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 2.0

    P.evaluate(build(a))
    new = _rand((32, 32), seed=2)
    a2 = a.update((slice(0, 32), slice(0, 32)), new)
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, new)
    line = _inc_line(P, build(a2))
    o.fact(len(line) == 1 and "incremental: full" in line[0]
           and "dirty-frac" in line[0])


@pytest.mark.parametrize("mesh", MESHES)
def test_full_overwrite_falls_back_with_reason(mesh, monkeypatch):
    _, ot = _both(_full_overwrite, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[0] == ("mode", "full", "dirty-frac:1.000")
    assert ot.facts[1] == (True,)


def _multi_leaf(P, o, mp):
    a_np, b_np = _rand((64, 64), 5), _rand((64, 64), 6)
    a, b = _arr(P, a_np), _arr(P, b_np)

    def build(x, y):
        return P.lazify(x) * 2.0 + P.lazify(y)

    P.evaluate(build(a, b))
    a2 = a.update((slice(0, 2), slice(0, 64)), 3.0)
    b2 = b.update((slice(6, 8), slice(0, 64)), 4.0)
    a2_np = a_np.copy()
    a2_np[0:2] = 3.0
    b2_np = b_np.copy()
    b2_np[6:8] = 4.0
    r = P.evaluate(build(a2, b2))
    o.mode(build(a2, b2))
    o.result(r.glom(), build, a2_np, b2_np)
    a3 = a2.update((slice(20, 22), slice(0, 64)), 9.0)
    a3_np = a2_np.copy()
    a3_np[20:22] = 9.0
    r2 = P.evaluate(build(a3, b2))
    o.mode(build(a3, b2))
    o.result(r2.glom(), build, a3_np, b2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_multi_leaf_updates_union_and_bitequal(mesh, monkeypatch):
    _, ot = _both(_multi_leaf, mesh, monkeypatch)
    assert ot.counters["incremental_hits"] == 2


def _reduce_axis(P, o, mp):
    a_np = _rand((64, 32), seed=7)
    a = _arr(P, a_np)

    def build(arr):
        return (P.lazify(arr) * 2.0).sum(axis=1)

    P.evaluate(build(a))
    a2 = a.update((slice(12, 14), slice(0, 32)), 5.0)
    a2_np = a_np.copy()
    a2_np[12:14] = 5.0
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_reduce_axis_delta_bitequal(mesh, monkeypatch):
    _, ot = _both(_reduce_axis, mesh, monkeypatch, rtol=SUM)
    assert ot.counters["incremental_hits"] == 1
    assert ot.counters["incremental_fallbacks"] == 0


def _reduce_all(P, o, mp):
    a_np = _rand((32, 32), seed=8)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr).sum()

    P.evaluate(build(a))
    a2 = a.update((slice(0, 1), slice(0, 4)), 2.0)
    a2_np = a_np.copy()
    a2_np[0, 0:4] = 2.0
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_reduce_all_falls_back_and_stays_correct(mesh, monkeypatch):
    _, ot = _both(_reduce_all, mesh, monkeypatch, rtol=SUM)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[0] == ("mode", "full", "dirty-full")


def _dot_column(P, o, mp):
    n = 64
    r_np = _rand((n,), seed=9)
    a_np = _rand((n, n), seed=10)
    r0, A = _arr(P, r_np), _arr(P, a_np)

    def build(rank, mat):
        return P.lazify(rank).dot(P.lazify(mat)) * 0.85 + 0.15 / n

    P.evaluate(build(r0, A))
    patch = _rand((n, 2), seed=11)
    A2 = A.update((slice(0, n), slice(6, 8)), patch)
    a2_np = a_np.copy()
    a2_np[:, 6:8] = patch
    r = P.evaluate(build(r0, A2))
    o.mode(build(r0, A2))
    o.result(r.glom(), build, r_np, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_dot_column_delta_bitequal(mesh, monkeypatch):
    """The JAX package runs this case on 4x2 only; on 8x1 its restricted
    column product misses its own full product's bits (the C1 hazard of
    XLA's CPU GEMV), so only the port is held to bit-equality there."""
    _, ot = _both(_dot_column, mesh, monkeypatch, rtol=SUM,
                  jax_bitequal=mesh == (4, 2))
    assert ot.counters["incremental_hits"] == 1
    assert ot.counters["incremental_recomputed_tiles"] > 0


def _matmul_row(P, o, mp):
    a_np = _rand((64, 32), seed=12)
    b_np = _rand((32, 48), seed=13)
    a, b = _arr(P, a_np), _arr(P, b_np)

    def build(x, y):
        return P.lazify(x) @ P.lazify(y)

    P.evaluate(build(a, b))
    a2 = a.update((slice(30, 32), slice(0, 32)), 0.25)
    a2_np = a_np.copy()
    a2_np[30:32] = 0.25
    r = P.evaluate(build(a2, b))
    o.mode(build(a2, b))
    o.result(r.glom(), build, a2_np, b_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_matmul_row_delta_bitequal(mesh, monkeypatch):
    """C1: the JAX side is not bit-equal to its own flag-off run (XLA's
    CPU GEMM); the port's is, and the modes and counters agree."""
    _, ot = _both(_matmul_row, mesh, monkeypatch, rtol=SUM,
                  jax_bitequal=False)
    assert ot.counters["incremental_hits"] == 1


def _loop_carry(P, o, mp):
    a_np = _rand((16, 16), seed=14)
    a = _arr(P, a_np)

    def build(arr):
        la = P.lazify(arr)
        return P.loop(3, lambda x: x * 0.5 + la, la)

    P.evaluate(build(a))
    a2 = a.update((slice(0, 2), slice(0, 16)), 1.0)
    a2_np = a_np.copy()
    a2_np[0:2] = 1.0
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_loop_carry_falls_back_full_and_stays_correct(mesh, monkeypatch):
    _, ot = _both(_loop_carry, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] >= 1


def _shuffle_identity(P, o, mp):
    a_np = _rand((16, 16), seed=15)

    def transpose_kernel(ext, block):
        yield (P.TileExtent((ext.ul[1], ext.ul[0]),
                            (ext.lr[1], ext.lr[0]), (16, 16)),
               np.ascontiguousarray(np.asarray(block).T))

    def run():
        src = P.shuffle(_arr(P, a_np), transpose_kernel,
                        target_shape=(16, 16), dtype=np.float32)
        return P.evaluate(src * 2.0)

    r1 = run()
    r2 = run()
    o.bitequal.append(bool(np.array_equal(r1.glom(),
                                          np.float32(2.0) * a_np.T)))
    o.bitequal.append(bool(np.array_equal(r2.glom(), r1.glom())))
    o.value(r2.glom())


@pytest.mark.parametrize("mesh", MESHES)
def test_shuffle_output_new_identity_falls_back_full(mesh, monkeypatch):
    _, ot = _both(_shuffle_identity, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1


def _scalar_change(P, o, mp):
    a_np = _rand((32, 32), seed=16)
    a = _arr(P, a_np)
    P.evaluate(P.lazify(a) * 2.0)
    r = P.evaluate(P.lazify(a) * 3.0)
    o.mode(P.lazify(a) * 3.0)
    o.bitequal.append(bool(np.array_equal(r.glom(), np.float32(3.0) * a_np)))
    o.value(r.glom())


@pytest.mark.parametrize("mesh", MESHES)
def test_scalar_constant_change_falls_back_full(mesh, monkeypatch):
    _, ot = _both(_scalar_change, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1


def _loop_stream(P, o, mp):
    a_np = _rand((16, 16), seed=17)
    a = _arr(P, a_np)

    def build(arr):
        return P.loop(2, lambda x: x * 0.5, P.lazify(arr))

    P.evaluate(build(a))
    cur_np = a_np.copy()
    for i in range(3):
        a = a.update((slice(i, i + 1), slice(0, 16)), float(i))
        cur_np[i] = float(i)
        r = P.evaluate(build(a))
        o.mode(build(a))
        o.result(r.glom(), build, cur_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_update_inside_loop_body_stream(mesh, monkeypatch):
    _, ot = _both(_loop_stream, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 3


# -- propagation rules (whitebox) ----------------------------------------


def _box(r):
    return r if r is None or not hasattr(r, "ul") else (tuple(r.ul),
                                                        tuple(r.lr))


def _prop_map(P, o, mp):
    E = P.TileExtent
    a = P.lazify(_arr(P, _rand((8, 8))))
    b = P.lazify(_arr(P, _rand((8,))))
    ex = a + b
    o.fact(_box(P.inc._propagate(ex, {a._id: E((2, 0), (4, 8), (8, 8))},
                                 {}, [])))
    o.fact(P.inc._propagate(ex, {b._id: E((0,), (2,), (8,))}, {}, [])
           is P.inc.FULL)
    o.fact(P.inc._propagate(ex, {}, {}, []))


@pytest.mark.parametrize("mesh", MESHES)
def test_propagation_map_box_passthrough_and_broadcast_full(mesh,
                                                            monkeypatch):
    _, ot = _both(_prop_map, mesh, monkeypatch)
    assert ot.facts == [(((2, 0), (4, 8)),), (True,), (None,)]


def _prop_reduce(P, o, mp):
    E = P.TileExtent
    a = P.lazify(_arr(P, _rand((8, 8))))
    box = E((2, 1), (4, 3), (8, 8))
    o.fact(_box(P.inc._propagate((a * 2.0).sum(axis=1), {a._id: box},
                                 {}, [])))
    o.fact(_box(P.inc._propagate((a * 2.0).sum(axis=0, keepdims=True),
                                 {a._id: box}, {}, [])))
    o.fact(P.inc._propagate((a * 2.0).sum(), {a._id: box}, {}, [])
           is P.inc.FULL)


@pytest.mark.parametrize("mesh", MESHES)
def test_propagation_reduce_collapse_rules(mesh, monkeypatch):
    _, ot = _both(_prop_reduce, mesh, monkeypatch)
    assert ot.facts == [(((2,), (4,)),), (((0, 1), (1, 3)),), (True,)]


def _prop_dot(P, o, mp):
    E = P.TileExtent
    a = P.lazify(_arr(P, _rand((8, 4))))
    b = P.lazify(_arr(P, _rand((4, 6))))
    ex = P.DotExpr(a, b)
    rows = E((2, 0), (5, 4), (8, 4))
    cols = E((0, 1), (4, 3), (4, 6))
    o.fact(_box(P.inc._propagate(ex, {a._id: rows}, {}, [])))
    o.fact(_box(P.inc._propagate(ex, {b._id: cols}, {}, [])))
    o.fact(P.inc._propagate(ex, {a._id: rows, b._id: cols}, {}, [])
           is P.inc.FULL)


@pytest.mark.parametrize("mesh", MESHES)
def test_propagation_dot_rules(mesh, monkeypatch):
    _, ot = _both(_prop_dot, mesh, monkeypatch)
    assert ot.facts == [(((2, 0), (5, 6)),), (((0, 1), (8, 3)),), (True,)]


def _quantize(P, o, mp):
    E = P.TileExtent
    o.fact(_box(P.inc._quantize(E((3, 5), (6, 9), (16, 16)), (16, 16))))
    o.fact(_box(P.inc._quantize(E((15, 0), (16, 16), (16, 16)),
                                (16, 16))))
    o.fact(_box(P.inc._quantize(E((10, 0), (16, 1), (16, 16)), (16, 16))))


@pytest.mark.parametrize("mesh", MESHES)
def test_quantize_pow2_and_clamped(mesh, monkeypatch):
    _, ot = _both(_quantize, mesh, monkeypatch)
    assert ot.facts[0] == (((3, 5), (7, 9)),)
    assert ot.facts[1] == (((15, 0), (16, 16)),)


# -- fencing, donation, budget -------------------------------------------


def _epoch_fence(P, o, mp):
    a = _arr(P, _rand((16, 16)))
    P.evaluate(P.lazify(a) + 1.0)
    o.fact(P.inc.cache_entries() >= 1, P.inc.evict_stale())
    P.mesh._EPOCH += 1
    try:
        P.base.evict_stale_plans()
        o.fact(P.inc.cache_entries(), P.inc.cache_bytes())
    finally:
        P.mesh._EPOCH -= 1


@pytest.mark.parametrize("mesh", MESHES)
def test_epoch_fence_purges_entries(mesh, monkeypatch):
    _, ot = _both(_epoch_fence, mesh, monkeypatch)
    assert ot.facts == [(True, 0), (0, 0)]
    assert ot.counters["incremental_evictions"] == 1


def _donated_update(P, o, mp):
    a = _arr(P, _rand((16, 16)))
    ex = P.lazify(a) * 2.0
    a.donate()
    P.evaluate(ex)
    o.fact(a.is_donated)
    with pytest.raises(RuntimeError, match="after donation.*donated at"):
        a.update((slice(0, 2), slice(0, 4)), 0.0)


@pytest.mark.parametrize("mesh", MESHES)
def test_update_after_donation_raises_with_site(mesh, monkeypatch):
    _, ot = _both(_donated_update, mesh, monkeypatch)
    assert ot.facts == [(True,)]


def _donated_leaf(P, o, mp):
    a = _arr(P, _rand((16, 16), seed=18))
    P.evaluate(P.lazify(a) * 2.0)
    ex = P.lazify(a) * 2.0
    a.donate()
    r = P.evaluate(ex)
    o.mode(P.lazify(P.da.from_numpy(_rand((16, 16)))) * 2.0)
    o.fact(a.is_donated, r.glom().shape)


@pytest.mark.parametrize("mesh", MESHES)
def test_donated_leaf_evaluate_falls_back(mesh, monkeypatch):
    _, ot = _both(_donated_leaf, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[0] == ("mode", "full", "donation")


def _donated_result(P, o, mp):
    a_np = _rand((16, 16), seed=19)
    a = _arr(P, a_np)
    r1 = P.evaluate(P.lazify(a) * 2.0)
    consume = P.lazify(r1) + 1.0
    r1.donate()
    P.evaluate(consume)
    o.fact(r1.is_donated)
    r2 = P.evaluate(P.lazify(a) * 2.0)
    o.mode(P.lazify(a) * 2.0)
    o.bitequal.append(bool(np.array_equal(r2.glom(),
                                          np.float32(2.0) * a_np)))
    o.value(r2.glom())


@pytest.mark.parametrize("mesh", MESHES)
def test_donated_cached_result_drops_entry(mesh, monkeypatch):
    _, ot = _both(_donated_result, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[1] == ("mode", "full", "result-donated")


def _budget(P, o, mp):
    one = int(np.prod((32, 32))) * 4
    P.FLAGS.result_cache_bytes = 2 * one + 64
    for seed in range(4):
        a = _arr(P, _rand((32, 32), seed=seed))
        P.evaluate(P.lazify(a) * float(seed + 2))
    o.fact(P.inc.cache_bytes() <= P.FLAGS.result_cache_bytes,
           P.inc.cache_entries())
    P.inc.clear()
    P.FLAGS.result_cache_bytes = one - 1
    a = _arr(P, _rand((32, 32), seed=9))
    P.evaluate(P.lazify(a) * 2.0)
    o.fact(P.inc.cache_entries())


@pytest.mark.parametrize("mesh", MESHES)
def test_result_cache_budget_is_bounded(mesh, monkeypatch):
    _, ot = _both(_budget, mesh, monkeypatch)
    assert ot.facts[0][0] and ot.facts[0][1] <= 2
    assert ot.facts[1] == (0,)


def _flag_off(P, o, mp):
    P.FLAGS.incremental = False
    P.inc.clear()
    a_np = _rand((32, 32), seed=20)
    a = _arr(P, a_np)
    P.evaluate(P.lazify(a) + 1.0)
    a2 = a.update((slice(0, 2), slice(0, 32)), 5.0)
    r = P.evaluate(P.lazify(a2) + 1.0)
    a2_np = a_np.copy()
    a2_np[0:2] = 5.0
    o.bitequal.append(bool(np.array_equal(r.glom(),
                                          a2_np + np.float32(1.0))))
    o.fact(P.inc.cache_entries())
    # the flag off: an update stashes nothing
    o.fact(a2._lineage.stash_bytes)


@pytest.mark.parametrize("mesh", MESHES)
def test_flag_off_no_cache_activity(mesh, monkeypatch):
    _, ot = _both(_flag_off, mesh, monkeypatch)
    assert ot.facts == [(0,), (0,)]
    assert ot.counters["incremental_hits"] == 0
    assert ot.counters["incremental_fallbacks"] == 0


# -- chaos leg ------------------------------------------------------------


def _chaos(P, o, mp):
    P.FLAGS.retry_max = 0
    a_np = _rand((64, 64), seed=21)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 2.0 + 1.0

    P.evaluate(build(a))
    a2 = a.update((slice(4, 6), slice(0, 64)), 3.0)
    a2_np = a_np.copy()
    a2_np[4:6] = 3.0
    with P.st.chaos("transient@0"):
        r = P.evaluate(build(a2))
    o.mode(build(a2))
    o.result(r.glom(), build, a2_np)
    line = _inc_line(P, build(a2))
    o.fact(len(line) == 1 and "fallback: error:" in line[0])


@pytest.mark.parametrize("mesh", MESHES)
def test_chaos_mid_incremental_dispatch_degrades_to_full(mesh, monkeypatch):
    _, ot = _both(_chaos, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[-1] == (True,)


# -- observability --------------------------------------------------------


def _explain(P, o, mp):
    a_np = _rand((64, 64), seed=22)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 2.0

    P.evaluate(build(a))
    a2 = a.update((slice(8, 10), slice(0, 64)), 1.5)
    P.evaluate(build(a2))
    rep = str(P.st.explain(build(a2)))
    line = _inc_line(P, build(a2))
    o.fact(len(line), "incremental: incremental" in rep,
           "dirty_frac=" in rep, "box (" in rep,
           "dirty" in rep and "tile(s)" in rep)
    # the line without the cache's byte count (each package's own
    # residency accounting rides in the parentheses)
    o.fact(re.sub(r" \(cache .*\)$", "", line[0]))
    P.evaluate(build(a2))
    o.fact("incremental: cache-hit" in str(P.st.explain(build(a2))))


@pytest.mark.parametrize("mesh", MESHES)
def test_explain_shows_incremental_section(mesh, monkeypatch):
    _, ot = _both(_explain, mesh, monkeypatch)
    assert ot.facts[0] == (1, True, True, True, True)
    assert ot.facts[2] == (True,)


def _flightrec(P, o, mp):
    a = _arr(P, _rand((32, 32), seed=23))
    P.evaluate(P.lazify(a) * 4.0)
    P.evaluate(P.lazify(a) * 4.0)
    snap = P.st.flightrec()
    o.fact("incremental" in snap,
           snap["incremental"].get("incremental_hits", 0) >= 1,
           "incremental_cache_bytes" in snap["incremental"],
           P.st.metrics()["counters"].get("incremental_hits", 0) >= 1)


@pytest.mark.parametrize("mesh", MESHES)
def test_flightrec_and_metrics_surface_incremental(mesh, monkeypatch):
    _, ot = _both(_flightrec, mesh, monkeypatch)
    assert ot.facts == [(True, True, True, True)]


def _governor(P, o, mp):
    mesh = P.mesh.get_mesh()
    o.fact(P.memory.resident_cache_bytes_per_chip(mesh))
    a = _arr(P, _rand((32, 32), seed=24))
    P.evaluate(P.lazify(a) + 2.0)
    total = P.inc.cache_bytes()
    o.fact(total)
    per = P.memory.resident_cache_bytes_per_chip(mesh)
    ndev = 1
    for v in dict(mesh.shape).values():
        ndev *= v
    # the JAX package divides over its chips, the port charges its one
    # card (module docstring): each against its own rule
    o.fact(per == (total if P is T else total // ndev))


@pytest.mark.parametrize("mesh", MESHES)
def test_memory_governor_sees_result_cache(mesh, monkeypatch):
    _, ot = _both(_governor, mesh, monkeypatch)
    assert ot.facts[0] == (0,) and ot.facts[1][0] > 0
    assert ot.facts[2] == (True,)


# -- the mutation-seam stash ---------------------------------------------


def _stash_serves(P, o, mp):
    n, w = 64, 3
    a_np = _rand((n, n), seed=30)
    r_np = _rand((n,), seed=31)
    a, r = _arr(P, a_np), _arr(P, r_np)
    calls = []
    orig = P.inc._dyn_slice
    mp.setattr(P.inc, "_dyn_slice",
               lambda nn, box: calls.append(1) or orig(nn, box))

    def build(arr):
        return P.lazify(r).dot(P.lazify(arr)) * 0.5 + 0.1

    P.evaluate(build(a))
    cols = _rand((n, w), seed=32)
    a2 = a.update((slice(0, n), slice(5, 5 + w)), cols)
    o.fact(a2._lineage.stashed_between(a._version, a2._version)
           is not None)
    out = P.evaluate(build(a2))
    o.fact(len(calls))
    o.mode(build(a2))
    a2_np = a_np.copy()
    a2_np[:, 5:5 + w] = cols
    o.bitequal.append(bool(np.array_equal(
        out.glom(), _full_reference(P, build, a2_np))))
    o.value(out.glom())


@pytest.mark.parametrize("mesh", MESHES)
def test_stash_serves_delta_without_dynamic_slice(mesh, monkeypatch):
    _, ot = _both(_stash_serves, mesh, monkeypatch, rtol=SUM)
    assert ot.facts[:2] == [(True,), (0,)]
    assert ot.counters["incremental_hits"] == 1


def test_stash_serves_an_aligned_product_window_on_the_port(monkeypatch):
    """Port only: at a window on the order granule the restricted product
    takes the stash itself as its operand (no slice of the parent), and
    is bit-equal to the flag-off product."""
    P = T
    n, g = 1024, 256
    saved = {k: getattr(P.FLAGS, k) for k in _SAVED}
    P.FLAGS.incremental = True
    P.inc.clear()
    stashed, sliced = [], []
    real_from, real_slice = P.da.from_tensor, P.inc._dyn_slice
    monkeypatch.setattr(P.da, "from_tensor", lambda t, *a, **k: (
        stashed.append(tuple(t.shape)) or real_from(t, *a, **k)))
    monkeypatch.setattr(P.inc, "_dyn_slice", lambda nn, box: (
        sliced.append(box.shape) or real_slice(nn, box)))
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
            assert P.inc.order_granule(torch.device("cpu")) == g
            a_np, r_np = _rand((n, n), seed=33), _rand((n,), seed=34)
            a, r = _arr(P, a_np), _arr(P, r_np)

            def build(arr):
                return P.lazify(r).dot(P.lazify(arr)) * 0.5 + 0.1

            P.evaluate(build(a))
            cols = _rand((n, g), seed=35)
            a2 = a.update((slice(0, n), slice(g, 2 * g)), cols)
            stashed.clear()
            h0 = P.prof.counters().get("incremental_hits", 0)
            out = P.evaluate(build(a2)).glom()
            assert P.prof.counters().get("incremental_hits", 0) == h0 + 1
            assert (n, g) in stashed and not sliced
            a2_np = a_np.copy()
            a2_np[:, g:2 * g] = cols
            assert np.array_equal(out, _full_reference(P, build, a2_np))
    finally:
        P.inc.clear()
        for k, v in saved.items():
            setattr(P.FLAGS, k, v)


def _stash_absent(P, o, mp):
    a = _arr(P, _rand((16, 16), seed=33))
    b = a.update((slice(0, 16), slice(2, 4)), 1.5, reducer="add")
    o.fact(b._lineage.stashed_between(a._version, b._version) is None)
    c = _arr(P, _rand((16, 16), seed=34))
    d = c.update((slice(0, 16), slice(0, 2)), 1.0)
    e = d.update((slice(0, 16), slice(1, 3)), 2.0)
    o.fact(e._lineage.stashed_between(c._version, e._version) is None)
    o.fact(e._lineage.stashed_between(d._version, e._version) is not None)


@pytest.mark.parametrize("mesh", MESHES)
def test_stash_absent_for_reducers_and_sequential_writes(mesh, monkeypatch):
    _, ot = _both(_stash_absent, mesh, monkeypatch)
    assert ot.facts == [(True,), (True,), (True,)]


def _stash_cap(P, o, mp):
    mp.setattr(P.Lineage, "_STASH_MAX_BYTES", 8)
    a = _arr(P, _rand((16, 16), seed=35))
    b = a.update((slice(0, 16), slice(0, 4)), 3.0)
    o.fact(b._lineage.stashed_between(a._version, b._version) is None)
    box = b._lineage.dirty_between(a._version, b._version, a.shape)
    o.fact(tuple(box.ul), tuple(box.lr))


@pytest.mark.parametrize("mesh", MESHES)
def test_stash_respects_byte_cap(mesh, monkeypatch):
    _, ot = _both(_stash_cap, mesh, monkeypatch)
    assert ot.facts == [(True,), ((0, 0), (16, 4))]


# -- lineage branching ----------------------------------------------------


def _branch_lineage(P, o, mp):
    base = _arr(P, _rand((16, 16), seed=36))
    a = base.update((slice(0, 2), slice(0, 16)), 5.0)
    o.fact(a._lineage is base._lineage)
    b = base.update((slice(4, 6), slice(0, 16)), 7.0)
    o.fact(b._lineage is not a._lineage, base._lineage is a._lineage)
    c = b.update((slice(8, 10), slice(0, 16)), 9.0)
    o.fact(c._lineage is b._lineage)
    box = c._lineage.dirty_between(b._version, c._version, b.shape)
    o.fact(tuple(box.ul), tuple(box.lr))


@pytest.mark.parametrize("mesh", MESHES)
def test_branching_update_gets_fresh_lineage(mesh, monkeypatch):
    _, ot = _both(_branch_lineage, mesh, monkeypatch)
    assert ot.facts == [(True,), (True, True), (True,),
                        ((8, 0), (10, 16))]


def _branch_served(P, o, mp):
    a_np = _rand((32, 32), seed=37)
    base = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 2.0 + 1.0

    P.evaluate(build(base))
    a = base.update((slice(0, 2), slice(0, 32)), 5.0)
    P.evaluate(build(a))
    b = base.update((slice(4, 6), slice(0, 32)), 7.0)
    r = P.evaluate(build(b))
    o.mode(build(b))
    b_np = a_np.copy()
    b_np[4:6] = 7.0
    o.result(r.glom(), build, b_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_branching_update_is_not_served_a_sibling_delta(mesh, monkeypatch):
    _, ot = _both(_branch_served, mesh, monkeypatch)
    assert ot.facts[0] == ("mode", "full", "dirty-full")


# -- residency accounting -------------------------------------------------


def _accounting(P, o, mp):
    P.inc.clear()
    one = int(np.prod((32, 32))) * 4
    a_np = _rand((32, 32), seed=38)
    a = _arr(P, a_np)
    P.evaluate(P.lazify(a) + 1.0)
    o.fact(P.inc.cache_bytes() >= 2 * one)
    a2 = a.update((slice(0, 2), slice(0, 32)), 3.0)
    P.evaluate(P.lazify(a2) + 1.0)
    lin = a2._lineage
    o.fact(lin is not None and lin.stash_bytes > 0,
           P.inc.cache_bytes() >= 2 * one + lin.stash_bytes)
    o.fact(P.inc.cache_bytes())


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_accounting_includes_leaf_snapshots_and_stash(mesh,
                                                            monkeypatch):
    _, ot = _both(_accounting, mesh, monkeypatch)
    assert ot.facts[:2] == [(True,), (True, True)]


# -- dirt-phase failures --------------------------------------------------


def _dirt_error(P, o, mp):
    a_np = _rand((32, 32), seed=39)
    a = _arr(P, a_np)

    def build(arr):
        return P.lazify(arr) * 3.0

    P.evaluate(build(a))
    a2 = a.update((slice(0, 2), slice(0, 32)), 1.0)

    def boom(*_a, **_k):
        raise ValueError("malformed node")

    mp.setattr(P.inc, "_propagate", boom)
    r = P.evaluate(build(a2))
    o.mode(build(a2))
    a2_np = a_np.copy()
    a2_np[0:2] = 1.0
    mp.undo()
    o.result(r.glom(), build, a2_np)


@pytest.mark.parametrize("mesh", MESHES)
def test_dirt_phase_error_degrades_to_full(mesh, monkeypatch):
    _, ot = _both(_dirt_error, mesh, monkeypatch)
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.facts[0] == ("mode", "full", "error:ValueError")


# -- C39: a restricted sum with several kept axes after the reduced one --
#
# torch vectorizes a sum along an outer axis over the flattened run of
# the kept axes after it, so a restricted window of a 3-D sum takes
# another order than the full sum in the run's tail. The engine holds
# its 32-wide window only where one kept axis follows (the 2-D streams
# above) and falls back under ``reduction-order`` elsewhere.

C39_MESHES = [(1, 1), (4, 2), (8, 1), (2, 4)]
# (name, shape, region written with 1.0): each window touches the tail
# of the flattened kept run, where the full sum adds in another order
C39_CASES = [
    ("sum", (300, 3, 200), (slice(10, 12), slice(0, 3), slice(161, 190))),
    ("sum", (300, 5, 100), (slice(10, 12), slice(0, 5), slice(70, 90))),
    ("sum", (50, 3, 1000), (slice(10, 12), slice(0, 3), slice(965, 1000))),
    ("fused", (300, 3, 200), (slice(10, 12), slice(0, 3),
                              slice(161, 190))),
    ("keepdims", (300, 3, 200), (slice(10, 12), slice(0, 3),
                                 slice(161, 190))),
]


def _c39_expr(P, x, kind):
    e = P.lazify(x)
    if kind == "fused":
        return (e * 2 + 1).sum(axis=0)
    if kind == "keepdims":
        return e.sum(axis=0, keepdims=True)
    return e.sum(axis=0)


@pytest.mark.parametrize("case", range(len(C39_CASES)))
@pytest.mark.parametrize("mesh", C39_MESHES)
def test_c39_restricted_3d_sum_bit_equal_to_flag_off(mesh, case,
                                                     monkeypatch):
    kind, shape, region = C39_CASES[case]
    a = _rand(shape)

    def c39(P, o, mp):
        x = _arr(P, a)
        P.evaluate(_c39_expr(P, x, kind))
        x = x.update(region, 1.0)
        got = P.evaluate(_c39_expr(P, x, kind)).glom()
        o.mode(_c39_expr(P, x, kind))
        b = a.copy()
        b[region] = 1.0
        o.result(got, lambda y: _c39_expr(P, y, kind), b)

    ot = _run(T, c39, mesh, monkeypatch)
    assert ot.bitequal == [True]
    assert ot.facts == [("mode", "full", "reduction-order")]
    assert ot.counters["incremental_fallbacks"] == 1
    assert ot.counters["incremental_hits"] == 0


@pytest.mark.parametrize("mesh", C39_MESHES)
def test_c39_one_kept_axis_after_the_sum_stays_incremental(mesh,
                                                           monkeypatch):
    """The measured layout keeps its window: a 2-D column write and a
    3-D sum along the middle axis (one kept axis after it)."""
    cases = [((64, 256), (slice(5, 9), slice(70, 73)), 0),
             ((8, 300, 200), (slice(2, 3), slice(10, 12), slice(161, 190)),
              1)]

    def served(P, o, mp):
        for shape, region, axis in cases:
            a = _rand(shape, seed=len(shape))
            x = _arr(P, a)
            P.evaluate(P.lazify(x).sum(axis=axis))
            x = x.update(region, 1.0)
            got = P.evaluate(P.lazify(x).sum(axis=axis)).glom()
            o.mode(P.lazify(x).sum(axis=axis))
            b = a.copy()
            b[region] = 1.0
            o.result(got, lambda y: P.lazify(y).sum(axis=axis), b)

    ot = _run(T, served, mesh, monkeypatch)
    assert ot.bitequal == [True, True]
    assert ot.facts == [("mode", "incremental", None)] * 2
    assert ot.counters["incremental_hits"] == 2


# -- a group mesh ---------------------------------------------------------
#
# Gloo groups of 2 and 4 CPU processes (meshes 2x1 and 2x2), launched as
# tests/test_torch_local_storage.py launches them. Every rank runs the
# streams of _GROUP_STREAMS with the engine on and off; the parent runs
# the same streams on the port's logical mesh of the group's shape and
# through the JAX package's streaming drivers on its mesh of that shape.
# A stream is a window normalized after each push with fixed statistics
# (an elementwise map: bit-equal to the logical mesh's run too; the
# sums add per-rank partials on a group and in one pass on a logical
# mesh, so there the logical run is held to 1e-6),
# a PageRank correction after each edge insert (a restricted product:
# one-thread CPUs keep the full product's order at the granule), a sum
# along the split axis after each column-block write, and an uneven
# (63 x 33) map whose cache decision must agree across ranks at a budget
# of exactly its entry's bytes and one byte less.

import functools  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_JOIN_S = 240
UNEVEN = (63, 33)
UNEVEN_ENTRY = 2 * UNEVEN[0] * UNEVEN[1] * 4  # the result and its leaf

_GROUP_STREAMS = r"""
import numpy as np


def _modes(P, expr):
    plan = P.base.lookup_plan(P.base.plan_signature(expr)[0])
    inc = (plan.report or {}).get("incremental") or {}
    return [inc.get("mode"), inc.get("fallback")]


def _count(P):
    c = P.counters()
    return [int(c.get(k, 0)) for k in ("incremental_hits",
                                       "incremental_fallbacks")]


def _delta(a, b):
    return [x - y for x, y in zip(a, b)]


def window(P, on):
    P.FLAGS.incremental = on
    rng = np.random.RandomState(50)
    sw = P.streaming.SlidingWindowStats(64, 16)
    first = rng.rand(64, 16).astype(np.float32)
    sw.push(first)
    # fixed statistics from the host, replicated as a reduction leaves
    # them: the stream itself is elementwise
    rep = P.Tiling((None,))
    mean = P.st.from_numpy(first.mean(0), tiling=rep).evaluate()
    std = P.st.from_numpy(first.std(0), tiling=rep).evaluate()
    sw.normalized(mean, std)
    c0, coll = _count(P), 0
    outs, modes = [], []
    for _ in range(6):
        sw.push(rng.rand(3, 16).astype(np.float32))
        coll -= P.collectives()
        res = sw.normalized(mean, std)
        coll += P.collectives()  # the step's walk, not the glom
        outs.append(res.glom())
        modes.append(_modes(P, (P.lazify(sw.buf) - P.lazify(mean))
                            / (P.lazify(std) + 1e-12)))
    return outs, _delta(_count(P), c0), modes, coll


def pagerank(P, on):
    P.FLAGS.incremental = on
    n = 512
    a = np.random.RandomState(51).rand(n, n).astype(np.float32)
    a /= a.sum(1, keepdims=True)
    pr = P.streaming.IncrementalPageRank(P.st.from_numpy(a).evaluate(),
                                         rebase_every=10)
    pr.step()
    c0, coll0 = _count(P), P.collectives()
    g = np.random.RandomState(52)
    outs, modes = [], []
    for j in (3, 100, 300):
        pr.insert_edges(slice(j, j + 5),
                        g.rand(n, 5).astype(np.float32) / n)
        outs.append(pr.step().glom())
        modes.append(_modes(P, pr._step_expr()))
    return outs, _delta(_count(P), c0), modes, P.collectives() - coll0


def split_sum(P, on):
    P.FLAGS.incremental = on
    rng = np.random.RandomState(53)
    x = P.st.from_numpy(rng.rand(64, 256).astype(np.float32),
                        tiling=P.Tiling(("x", "y"))).evaluate()
    P.evaluate(P.lazify(x).sum(axis=0))
    c0, coll = _count(P), 0
    outs, modes = [], []
    for c in (3, 70, 140, 250):
        x = x.update((slice(5, 9), slice(c, c + 3)),
                     rng.rand(4, 3).astype(np.float32))
        coll -= P.collectives()
        res = P.evaluate(P.lazify(x).sum(axis=0))
        coll += P.collectives()
        outs.append(res.glom())
        modes.append(_modes(P, P.lazify(x).sum(axis=0)))
    return outs, _delta(_count(P), c0), modes, coll


def uneven(P, on, budget):
    P.FLAGS.incremental = on
    prev = P.FLAGS.result_cache_bytes
    P.FLAGS.result_cache_bytes = budget
    try:
        rng = np.random.RandomState(54)
        u = P.st.from_numpy(rng.rand(63, 33).astype(np.float32),
                            tiling=P.Tiling(("x", None))).evaluate()
        P.evaluate(P.lazify(u) * 2.0 + 1.0)
        c0 = _count(P)
        outs = []
        for r in (40, 7):
            u = u.update((slice(r, r + 3), slice(0, 33)),
                         rng.rand(3, 33).astype(np.float32))
            outs.append(P.evaluate(P.lazify(u) * 2.0 + 1.0).glom())
        return outs, _delta(_count(P), c0), P.inc.cache_entries()
    finally:
        P.FLAGS.result_cache_bytes = prev
        P.inc.clear()


C39 = [((300, 3, 200), (slice(10, 12), slice(0, 3), slice(161, 190)), "sum"),
       ((300, 5, 100), (slice(10, 12), slice(0, 5), slice(70, 90)), "sum"),
       ((50, 3, 1000), (slice(10, 12), slice(0, 3), slice(965, 1000)), "sum"),
       ((300, 3, 200), (slice(10, 12), slice(0, 3), slice(161, 190)),
        "fused"),
       ((300, 3, 200), (slice(10, 12), slice(0, 3), slice(161, 190)),
        "keepdims")]


def _c39_expr(P, x, kind):
    e = P.lazify(x)
    if kind == "fused":
        return (e * 2 + 1).sum(axis=0)
    if kind == "keepdims":
        return e.sum(axis=0, keepdims=True)
    return e.sum(axis=0)


def c39(P):
    # each warm 3-D sum after a write into the kept run's tail, and its
    # flag-off recompute over fresh arrays
    rng = np.random.RandomState(55)
    outs, facts = [], []
    for shape, region, kind in C39:
        a = rng.rand(*shape).astype(np.float32)
        P.FLAGS.incremental = True
        P.inc.clear()
        x = P.st.from_numpy(a).evaluate()
        P.evaluate(_c39_expr(P, x, kind))
        c0 = _count(P)
        x = x.update(region, 1.0)
        outs.append(P.evaluate(_c39_expr(P, x, kind)).glom())
        facts.append([_modes(P, _c39_expr(P, x, kind)),
                      _delta(_count(P), c0)])
        P.FLAGS.incremental = False
        b = a.copy()
        b[region] = 1.0
        outs.append(P.evaluate(_c39_expr(
            P, P.st.from_numpy(b).evaluate(), kind)).glom())
    P.inc.clear()
    return outs, facts


STREAMS = {"window": window, "pagerank": pagerank, "split_sum": split_sum}


def run_streams(P):
    res = {}
    for name, fn in STREAMS.items():
        for on in (True, False):
            P.inc.clear()
            res[(name, on)] = fn(P, on)
    P.FLAGS.incremental = False
    P.inc.clear()
    return res
"""

_GROUP_CHILD = r"""
import json, os, sys, types
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.examples import streaming
from spartan_tpu_torch.expr import base, incremental
from spartan_tpu_torch.obs.metrics import materialize_sites
from spartan_tpu_torch.utils import profiling as prof
from spartan_tpu_torch.utils.config import FLAGS

st.set_default_device("cpu")
assert st.initialize_distributed() is True
mesh = st.get_mesh()


def collectives():
    return sum(int(v) for k, v in st.metrics()["counters"].items()
               if k.startswith("collective_calls"))


P = types.SimpleNamespace(
    st=st, streaming=streaming, base=base, inc=incremental, FLAGS=FLAGS,
    Tiling=Tiling, lazify=base.lazify, evaluate=base.evaluate,
    counters=prof.counters, collectives=collectives)
ns = {}
exec(os.environ["STREAMS"], ns)
res = ns["run_streams"](P)
entry = int(os.environ["ENTRY"])
for budget in (entry, entry - 1):
    for on in (True, False):
        res[("uneven", budget, on)] = ns["uneven"](P, on, budget)
res[("c39",)] = ns["c39"](P)
arrays, facts = {}, {}
for key, val in res.items():
    name = "/".join(str(k) for k in key)
    for i, o in enumerate(val[0]):
        arrays[f"{name}/{i}"] = o
    facts[name] = [v for v in val[1:]]
facts["materialized"] = sum(materialize_sites().values())
# the plan audit's collectives of each restricted walk (its splice plan)
from spartan_tpu_torch.analysis import plan_audit
facts["audit"] = {
    str(list(p.dag.shape)): len(plan_audit.audit_built_plan(
        p, mesh).collectives)
    for p in list(base._plan_cache.values())
    if type(p.dag).__name__ == "_DynUpdateExpr"}
# st.explain of a warm step names the mode
FLAGS.incremental = True
pr = streaming.IncrementalPageRank(st.from_numpy(
    np.eye(512, dtype=np.float32)).evaluate(), rebase_every=10)
pr.step()
pr.insert_edges(slice(7, 9), np.full((512, 2), 0.5, np.float32))
pr.step()
facts["explain"] = [ln.strip() for ln in str(st.explain(
    pr._step_expr())).splitlines() if "incremental:" in ln]
FLAGS.incremental = False
incremental.clear()
st.shutdown()
out = os.environ["OUT"]
np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(facts, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


def _group_shape(world):
    return (2, 1) if world == 2 else (2, 2)


@functools.lru_cache(maxsize=None)
def _group_run(world: int):
    """Every rank's (arrays, facts) of _GROUP_CHILD on a gloo group."""
    tmp = tempfile.mkdtemp(prefix="incremental_group_")
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, OUT=tmp, STREAMS=_GROUP_STREAMS,
                   ENTRY=str(UNEVEN_ENTRY),
                   COORDINATOR_ADDRESS=f"file://{tmp}/store",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:  # a hung rank fails the test
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"CHILD_OK {rank}" in log, log[-3000:]
    outs = []
    for rank in range(world):
        arrays = dict(np.load(os.path.join(tmp, f"rank{rank}.npz")))
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            outs.append((arrays, json.load(f)))
    shutil.rmtree(tmp, ignore_errors=True)
    return outs


def _streams_ns():
    ns = {}
    exec(_GROUP_STREAMS, ns)
    return ns


def _ns_of(P):
    return types.SimpleNamespace(
        st=P.st, streaming=importlib.import_module(
            f"{P.name}.examples.streaming"),
        base=P.base, inc=P.inc, FLAGS=P.FLAGS,
        Tiling=importlib.import_module(f"{P.name}.array.tiling").Tiling,
        lazify=P.lazify, evaluate=P.evaluate, counters=P.prof.counters,
        collectives=lambda: 0)


@functools.lru_cache(maxsize=None)
def _reference_runs(world: int, pkg: str):
    """The flag-on streams on the logical mesh of the group's shape: the
    port's (``spartan_tpu_torch``) or the JAX package's."""
    P = T if pkg == T.name else J
    shape = _group_shape(world)
    ctx = (mesh_j.use_mesh(mesh_j.build_mesh(jax.devices()[:world],
                                             shape=shape))
           if P is J else mesh_t.use_mesh(mesh_t.build_mesh(shape, "cpu")))
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(P.FLAGS, n) for n in _SAVED}
    try:
        with ctx:
            ns, nsp = _streams_ns(), _ns_of(P)
            out = {}
            for name, fn in ns["STREAMS"].items():
                P.inc.clear()
                out[name] = [np.asarray(o) for o in fn(nsp, True)[0]]
            return out
    finally:
        P.inc.clear()
        for n, v in saved.items():
            setattr(P.FLAGS, n, v)
        mesh_t.set_default_device(prev)


_TOL = {"window": ELEM, "pagerank": SUM, "split_sum": SUM}


@pytest.mark.parametrize("world", [2, 4])
def test_group_streams_served_incrementally_and_bit_equal(world):
    outs = _group_run(world)
    logical = _reference_runs(world, T.name)
    for arrays, facts in outs:
        for name in ("window", "pagerank", "split_sum"):
            steps = len(logical[name])
            hits, falls = facts[f"{name}/True"][0]
            assert (hits, falls) == (steps, 0), (name, facts)
            assert facts[f"{name}/False"][0] == [0, 0]
            assert all(m == ["incremental", None]
                       for m in facts[f"{name}/True"][1]), name
            for i in range(steps):
                got = arrays[f"{name}/True/{i}"]
                # the flag-off group run, then the logical mesh's run:
                # bit-equal for the elementwise stream; the sums add
                # per-rank partials on a group and in one pass there
                np.testing.assert_array_equal(
                    got, arrays[f"{name}/False/{i}"], err_msg=name)
                if name == "window":
                    np.testing.assert_array_equal(got, logical[name][i])
                else:
                    np.testing.assert_allclose(got, logical[name][i],
                                               rtol=ELEM, atol=ELEM,
                                               err_msg=name)
        # the window stays where the ranks hold it: no collective, and
        # nothing gathered whole
        assert facts["window/True"][2] == 0
        assert facts["materialized"] == 0
        # a sum along the split axis still reduces over it
        assert facts["split_sum/True"][2] > 0
        # the plan audit of each restricted walk lists the collectives
        # the walk made: one all-reduce a step for the sum, none for
        # the window
        assert facts["audit"]["[256]"] * 4 == facts["split_sum/True"][2]
        assert facts["audit"]["[64, 16]"] == 0
        assert facts["explain"] and facts["explain"][0].startswith(
            "incremental: incremental, dirty_frac="), facts["explain"]
    # every rank took the same decisions
    for _, facts in outs[1:]:
        assert facts == outs[0][1]


@pytest.mark.parametrize("world", [2, 4])
def test_group_streams_within_tolerance_of_jax(world):
    outs = _group_run(world)
    want = _reference_runs(world, J.name)
    arrays = outs[0][0]
    for name, tol in _TOL.items():
        for i, w in enumerate(want[name]):
            np.testing.assert_allclose(arrays[f"{name}/True/{i}"], w,
                                       rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_group_uneven_cache_decision_agrees_across_ranks(world):
    outs = _group_run(world)
    for arrays, facts in outs:
        # at the entry's global bytes every rank caches and serves both
        # writes; one byte less and no rank caches
        assert facts[f"uneven/{UNEVEN_ENTRY}/True"][0] == [2, 0]
        assert facts[f"uneven/{UNEVEN_ENTRY - 1}/True"][0] == [0, 0]
        for budget in (UNEVEN_ENTRY, UNEVEN_ENTRY - 1):
            for i in range(2):
                np.testing.assert_array_equal(
                    arrays[f"uneven/{budget}/True/{i}"],
                    arrays[f"uneven/{budget}/False/{i}"])
    for _, facts in outs[1:]:
        assert facts == outs[0][1]


@pytest.mark.parametrize("world", [2, 4])
def test_group_c39_sums_fall_back_bit_equal(world):
    """C39 on a group: each rank sums its block of the 3-D array, and the
    warm sum falls back under ``reduction-order`` on every rank,
    bit-equal to the group's flag-off recompute."""
    outs = _group_run(world)
    ns = _streams_ns()
    for arrays, facts in outs:
        assert facts["c39"][0] == [[["full", "reduction-order"], [0, 1]]] \
            * len(ns["C39"])
        for i in range(len(ns["C39"])):
            np.testing.assert_array_equal(arrays[f"c39/{2 * i}"],
                                          arrays[f"c39/{2 * i + 1}"])
