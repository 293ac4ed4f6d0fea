"""The port's planner tier against the JAX package, on the CPU.

The smart-tiling cost model (``expr/tiling_cost.py``), the smart-tiling
pass and the redistribution planner (``parallel/redistribute.py``) are
pure Python over tilings in both packages: on the same logical meshes
(4x2, 8x1, 2x4) they must price every edge alike (within 1e-9
relative), commit the same ``_forced_tiling`` axes and ``_dot_plan`` on
every node of the same DAG, and make the same redistribution decisions.
``apply_schedule`` moves the logical shards of one tensor, so it must be
bit-exact; ``retile``, ``replicate`` and ``map_shards`` must give the JAX
package's values.
"""

import contextlib
import importlib

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.examples import kmeans as kmeans_j
from spartan_tpu.expr import tiling_cost as cost_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.parallel import redistribute as redist_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.examples import kmeans as kmeans_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.expr import tiling_cost as cost_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.parallel import redistribute as redist_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

# the modules (each package's expr namespace exports a function
# ``optimize`` that shadows the submodule attribute)
optimize_j = importlib.import_module("spartan_tpu.expr.optimize")
optimize_t = importlib.import_module("spartan_tpu_torch.expr.optimize")

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]
REL = 1e-9


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield mesh_j.get_mesh(), mesh_t.get_mesh()


@contextlib.contextmanager
def _flags(**kw):
    """Set the same flags in both packages, restored on exit."""
    prev = {k: (getattr(FLAGS_J, k), getattr(FLAGS_T, k)) for k in kw}
    for k, v in kw.items():
        setattr(FLAGS_J, k, v)
        setattr(FLAGS_T, k, v)
    try:
        yield
    finally:
        for k, (vj, vt) in prev.items():
            setattr(FLAGS_J, k, vj)
            setattr(FLAGS_T, k, vt)


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-12), (a, b)


def _sched_view(s):
    return (s.describe(), sorted(s.comm_frac.items()), s.peak_frac,
            s.states)


# -- edge pricing: every pair of candidate tilings ---------------------------


@pytest.mark.parametrize("shape", [(16, 8), (8, 16, 4), (6, 8)])
@pytest.mark.parametrize("mesh", MESHES)
def test_candidates_and_edge_prices_match_jax(mesh, shape):
    with _meshes(mesh) as (mj, mt):
        cj = [t.axes for t in cost_j.candidates(st_j.zeros(shape), mj)]
        ct = [t.axes for t in cost_t.candidates(st_t.zeros(shape), mt)]
        assert ct == cj  # order too: exact cost ties pick the earlier
        nbytes = float(np.prod(shape)) * 4
        for sa in cj:
            for da in cj:
                sj, dj = tiling_j.Tiling(sa), tiling_j.Tiling(da)
                st, dt = tiling_t.Tiling(sa), tiling_t.Tiling(da)
                _close(cost_t.reshard_cost(st, dt, nbytes, mt),
                       cost_j.reshard_cost(sj, dj, nbytes, mj))
                _close(redist_t.edge_cost(st, dt, nbytes, mt),
                       redist_j.edge_cost(sj, dj, nbytes, mj))
                assert redist_t.staging_frac(st, dt, mt) == \
                    redist_j.staging_frac(sj, dj, mj)
                assert [_sched_view(s) for s in
                        redist_t.schedules(st, dt, mt)] == \
                    [_sched_view(s) for s in redist_j.schedules(sj, dj, mj)]
                assert redist_t.edge_components(st, dt, nbytes, mt) == \
                    redist_j.edge_components(sj, dj, nbytes, mj)
                got = redist_t.decide(st, dt, shape, np.float32, mt)
                want = redist_j.decide(sj, dj, shape, np.float32, mj)
                assert (got is None) == (want is None)
                if want is not None:
                    assert got.schedule.describe() == \
                        want.schedule.describe()
                    assert (got.explicit, got.reason) == \
                        (want.explicit, want.reason)
                    _close(got.cost, want.cost)
                    _close(got.gspmd_cost, want.gspmd_cost)


@pytest.mark.parametrize("shape", [(16, 8), (8, 8, 4)])
def test_cross_mesh_transitions_match_jax(shape):
    sizes = [({"x": 4, "y": 2}, {"x": 2, "y": 2}),
             ({"x": 8, "y": 1}, {"x": 4, "y": 1}),
             ({"x": 2, "y": 4}, {"x": 2, "y": 2})]
    with _meshes((4, 2)) as (mj, _):
        cands = [t.axes for t in cost_j.candidates(st_j.zeros(shape), mj)]
    for src_sizes, dst_sizes in sizes:
        for sa in cands:
            for da in cands:
                want = redist_j.plan_transition(
                    tiling_j.Tiling(sa), tiling_j.Tiling(da), src_sizes,
                    dst_sizes, shape, np.float32)
                got = redist_t.plan_transition(
                    tiling_t.Tiling(sa), tiling_t.Tiling(da), src_sizes,
                    dst_sizes, shape, np.float32)
                assert (got.route, got.reason) == (want.route, want.reason)
                _close(got.cost, want.cost)
                _close(got.bytes, want.bytes)


# -- the DP's committed plans on whole DAGs -----------------------------------


def _bench_chain(st, n):
    """bench.py's dot chain: K = 64 products in one st.loop, renormalised
    every 8th hop (bench.py ``_build``)."""
    a = np.zeros((n, n), np.float32)
    ea, eb = st.from_numpy(a), st.from_numpy(a)

    def body8(c):
        for _ in range(8):
            c = st.dot(c, eb)
        return c / st.absolute(c).max()

    return st.loop(64 // 8, body8, ea).sum()


def _kmeans_step(st, _n):
    rng = np.random.RandomState(0)
    pts = st.from_numpy(rng.rand(64, 8).astype(np.float32))
    ctr = st.from_numpy(rng.rand(4, 8).astype(np.float32))
    step = kmeans_j.kmeans_step if st is st_j else kmeans_t.kmeans_step
    return step(pts, ctr, 4)


def _transpose_chain(st, _n):
    rng = np.random.RandomState(1)
    x = st.from_numpy(rng.rand(32, 16).astype(np.float32))
    y = st.from_numpy(rng.rand(32, 8).astype(np.float32))
    return st.transpose(st.dot(st.dot(x, st.transpose(x)), y)) + 1.0


def _einsum(st, _n):
    rng = np.random.RandomState(2)
    a = st.from_numpy(rng.rand(4, 8, 6).astype(np.float32))
    b = st.from_numpy(rng.rand(4, 6, 8).astype(np.float32))
    c = st.from_numpy(rng.rand(8, 16).astype(np.float32))
    return st.einsum("bij,bjk,kl->bil", a, b, c)


def _tl(st):
    return tiling_j if st is st_j else tiling_t


def _tiled(st, tl, shape, seed):
    a = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return st.from_numpy(a, tiling=tl)


# tests/test_tiling_cost.py's DAGs, the same inputs in both packages
def _tc_sharded_chain(st, _n):
    tl = _tl(st)
    x = _tiled(st, tl.row(2), (64, 64), 3)
    y = _tiled(st, tl.row(2), (64, 64), 4)
    return (x + y) * 2.0


def _tc_thrash(st, _n):
    tl = _tl(st)
    return _tiled(st, tl.row(2), (64, 64), 5) + \
        _tiled(st, tl.col(2), (64, 64), 6)


def _tc_toggle(st, _n):
    tl = _tl(st)
    ea = _tiled(st, tl.row(2), (16, 16), 7)
    eb = _tiled(st, tl.col(2), (16, 16), 8)
    return ((ea + eb).dot(st.transpose(ea)) + 1.0).sum(axis=0)


def _tc_dot_row_t(st, _n):
    tl = _tl(st)
    return st.dot(_tiled(st, tl.row_t(2), (32, 32), 9),
                  _tiled(st, tl.row_t(2), (32, 32), 10))


def _tc_dot_psum(st, _n):
    tl = _tl(st)
    return st.dot(_tiled(st, tl.row_t(2), (32, 32), 11),
                  _tiled(st, tl.row(2), (32, 32), 12))


def _tc_dot_block(st, _n):
    tl = _tl(st)
    return st.dot(_tiled(st, tl.row(2), (32, 32), 13),
                  _tiled(st, tl.col(2), (32, 32), 14))


def _tc_dot_transposed(st, _n):
    a = np.random.RandomState(15).rand(16, 16).astype(np.float32)
    return st.transpose(st.dot(st.from_numpy(a), st.from_numpy(a)))


DAGS = {"bench_chain_4096": (_bench_chain, 4096),
        "kmeans_step": (_kmeans_step, 0),
        "transpose_chain": (_transpose_chain, 0),
        "einsum_chain": (_einsum, 0),
        "tc_sharded_chain": (_tc_sharded_chain, 0),
        "tc_thrash": (_tc_thrash, 0),
        "tc_toggle": (_tc_toggle, 0),
        "tc_dot_row_t": (_tc_dot_row_t, 0),
        "tc_dot_psum": (_tc_dot_psum, 0),
        "tc_dot_block": (_tc_dot_block, 0),
        "tc_dot_transposed": (_tc_dot_transposed, 0)}


def _plans(dag, optimize_mod, redist_mod, mesh):
    """Per node, post-order: type, shape, committed tiling, GEMM plan,
    and the redistribution decision at each forced edge."""
    out = []
    for n in optimize_mod.dag_nodes(dag):
        forced = n._forced_tiling.axes if n._forced_tiling else None
        plan = getattr(n, "_dot_plan", None)
        if plan is not None:
            plan = (plan[0].axes, plan[1])
        dec = None
        if n._forced_tiling is not None:
            d = redist_mod.decide(n._default_tiling(), n._forced_tiling,
                                  n.shape, n.dtype, mesh)
            dec = None if d is None else (d.schedule.describe(),
                                          d.explicit, d.reason)
        out.append((type(n).__name__, n.shape, forced, plan, dec))
    return out


def _dag_plans(name, mesh):
    build, n = DAGS[name]
    with _meshes(mesh) as (mj, mt):
        want = _plans(optimize_j.optimize(build(st_j, n)), optimize_j,
                      redist_j, mj)
        got = _plans(optimize_t.optimize(build(st_t, n)), optimize_t,
                     redist_t, mt)
    return got, want


@pytest.mark.parametrize("name", sorted(DAGS))
@pytest.mark.parametrize("mesh", MESHES)
def test_dp_commits_jax_tilings_and_plans(mesh, name):
    # the fused k-means node is the port's own (ROADMAP C22): the
    # map2 form is the DAG both packages share
    with _flags(native_kernels="off") if name == "kmeans_step" \
            else contextlib.nullcontext():
        got, want = _dag_plans(name, mesh)
    assert got == want
    if mesh != (1, 1) and name.startswith(("bench", "tc_dot")):
        assert any(p[3] is not None for p in got)  # a GEMM was planned


@pytest.mark.parametrize("name", ["bench_chain_4096", "transpose_chain",
                                  "tc_dot_row_t", "tc_toggle",
                                  "einsum_chain"])
@pytest.mark.parametrize("mesh", MESHES)
def test_dp_with_planner_on_matches_jax(mesh, name):
    with _flags(redistribution_planner=True):
        got, want = _dag_plans(name, mesh)
    assert got == want


def test_flop_weight_keys_the_mesh_device_type():
    with _meshes((4, 2)) as (_, mt):
        assert cost_t._flop_weight(mt) == 0.005  # the cpu calibration
        assert cost_t.calibrate_flop_weight(mesh=mt) == 0.005
    cuda_mesh = mesh_t.Mesh((4, 2), torch.device("cuda"))
    assert cost_t._flop_weight(cuda_mesh) == cost_t._FLOP_WEIGHT_FALLBACK
    with _flags(tiling_flop_weight=0.25):
        assert cost_t._flop_weight(cuda_mesh) == 0.25


def test_gemm_plan_costs_and_class_components_match_jax():
    with _meshes((4, 2)):
        dj = _tc_toggle(st_j, 0)
        dt = _tc_toggle(st_t, 0)
        cj = {type(n).__name__: [(t.axes, s, c) for t, s, c in v]
              for n, v in cost_j.gemm_plan_costs(dj).items()}
        ct = {type(n).__name__: [(t.axes, s, c) for t, s, c in v]
              for n, v in cost_t.gemm_plan_costs(dt).items()}
        assert ct.keys() == cj.keys() and ct
        for k in cj:
            assert [x[:2] for x in ct[k]] == [x[:2] for x in cj[k]]
            for a, b in zip(ct[k], cj[k]):
                _close(a[2], b[2])
        oj = optimize_j.optimize(dj)
        ot = optimize_t.optimize(dt)
        assert cost_t.class_components(ot) == cost_j.class_components(oj)
        assert cost_t.explain(ot).replace(str(ot._id), "") .count(
            "tiling=") == cost_j.explain(oj).count("tiling=")


# -- apply_schedule: explicit schedules are bit-exact ---------------------------


@pytest.mark.parametrize("shape", [(16, 8), (8, 16, 4)])
@pytest.mark.parametrize("mesh", MESHES)
def test_apply_schedule_is_bit_exact(mesh, shape):
    val = torch.from_numpy(
        np.random.RandomState(16).randn(*shape).astype(np.float32))
    ran = 0
    with _meshes(mesh) as (_, mt):
        cands = cost_t.candidates(st_t.zeros(shape), mt)
        for s in cands:
            for d in cands:
                for sched in redist_t.schedules(s, d, mt):
                    if not all(tiling_t.Tiling(a).divisible(shape, mt)
                               for a in (s.axes,) + sched.states):
                        continue
                    out = redist_t.apply_schedule(val, sched, s, d, mt)
                    assert torch.equal(out, val), (s, d, sched)
                    ran += 1
    assert ran > 0


def _planned_dag(st):
    """A DAG whose DP plan holds a one-step all_to_all edge on 4x2."""
    tl = _tl(st)
    x = _tiled(st, tl.row(2), (32, 32), 17)
    y = _tiled(st, tl.row(2), (32, 32), 18)
    return st.dot(st.transpose(x) + 1.0, y) * 0.5


def test_planner_on_and_off_give_the_same_values():
    with _meshes((4, 2)):
        want = np.asarray(_planned_dag(st_j).glom())
        off = _planned_dag(st_t).glom()
        prof_t.reset_counters()
        with _flags(redistribution_planner=True):
            on = _planned_dag(st_t).glom()
        counts = prof_t.counters()
    np.testing.assert_array_equal(on, off)
    np.testing.assert_allclose(off, want, rtol=1e-5, atol=1e-5)
    assert counts.get("redistribute_explicit", 0) + \
        counts.get("redistribute_fallback", 0) > 0


def test_constrain_explicit_all_to_all_moves_shards_bit_exact():
    val = torch.from_numpy(
        np.random.RandomState(19).rand(32, 16).astype(np.float32))
    src, dst = tiling_t.row(2), tiling_t.Tiling((None, "x"))
    with _meshes((4, 2)) as (mj, mt):
        want = redist_j.decide(tiling_j.row(2),
                               tiling_j.Tiling((None, "x")), (32, 16),
                               np.float32, mj)
        assert want.explicit
        assert redist_t.constrain(val, dst, mt, src=src) is val  # off
        prof_t.reset_counters()
        with _flags(redistribution_planner=True):
            out = redist_t.constrain(val, dst, mt, src=src)
            same = redist_t.constrain(val, src, mt, src=src)
        assert prof_t.counters().get("redistribute_explicit") == 1
    assert out is not val and torch.equal(out, val)
    assert same is val


# -- plan keys: the pass and the planner flags never alias ----------------------


@pytest.mark.parametrize("order", ["on_first", "off_first"])
@pytest.mark.parametrize("flag", ["opt_auto_tiling",
                                  "redistribution_planner"])
def test_plan_key_separates_flag_states(flag, order):
    default = getattr(FLAGS_T, flag)
    states = [not default, default] if order == "off_first" \
        else [default, not default]
    with _meshes((4, 2)):
        keys, tilings = [], []
        for v in states + states:
            with _flags(**{flag: v}):
                e = _tc_dot_row_t(st_t, 0)
                keys.append(base_t.plan_signature(e)[0])
                base_t.reset_plan_stats()
                r = e.evaluate()
                tilings.append(r.tiling.axes)
                hit = base_t.plan_stats()["plan_hits"]
        assert keys[0] != keys[1] and keys[0] == keys[2] \
            and keys[1] == keys[3]
        assert tilings[0] == tilings[2] and tilings[1] == tilings[3]
        assert hit == 1  # the second round hits its own plan


# -- retile / replicate / map_shards --------------------------------------------


_TILINGS = [("x", None), (None, "y"), ("x", "y"), (None, None),
            ("y", "x"), (None, "x")]


@pytest.mark.parametrize("mesh", MESHES)
def test_retile_replicate_map_shards_match_jax(mesh):
    a = np.random.RandomState(20).randint(-50, 50, (16, 8)).astype(np.int32)
    with _meshes(mesh):
        xj, xt = st_j.from_numpy(a).evaluate(), st_t.from_numpy(a).evaluate()
        for axes in _TILINGS:
            rj = xj.retile(tiling_j.Tiling(axes))
            rt = xt.retile(tiling_t.Tiling(axes))
            assert rt.tiling.axes == rj.tiling.axes
            np.testing.assert_array_equal(rt.glom(), np.asarray(rj.glom()))
            mj = rj.map_shards(lambda b: b - b.max() + b[:1, :1])
            mt = rt.map_shards(lambda b: b - b.max() + b[:1, :1])
            assert mt.tiling.axes == mj.tiling.axes
            np.testing.assert_array_equal(mt.glom(), np.asarray(mj.glom()))
        pj, pt = xj.replicate(), xt.replicate()
        assert pt.tiling.axes == pj.tiling.axes == (None, None)
        np.testing.assert_array_equal(pt.glom(), np.asarray(pj.glom()))
        assert xt.retile(xt.tiling) is xt


def test_map_shards_needs_divisible_tiling():
    with _meshes((4, 2)):
        x = st_t.from_numpy(np.zeros((6, 8), np.float32)).evaluate()
        with pytest.raises(ValueError, match="divides"):
            x.retile(tiling_t.row(2)).map_shards(lambda b: b)


def test_retile_shares_the_tensor_and_donation_keeps_the_other_handle():
    a = np.arange(32, dtype=np.float32).reshape(8, 4)
    with _meshes((4, 2)):
        x = st_t.from_numpy(a).evaluate()
        r = x.retile(tiling_t.col(2))
        assert r.tensor.data_ptr() == x.tensor.data_ptr()
        out = st_t.evaluate(st_t.as_expr(x) + 1.0, donate=[x])
        assert x.is_donated and not r.is_donated
        np.testing.assert_array_equal(r.glom(), a)
        np.testing.assert_array_equal(out.glom(), a + 1.0)
        y = st_t.from_numpy(a).evaluate()
        z = y.retile(tiling_t.row(2))
        st_t.evaluate(st_t.as_expr(z) * 2.0, donate=[z])
        assert z.is_donated and not y.is_donated
        np.testing.assert_array_equal(y.glom(), a)


# -- loop-carry sharding ------------------------------------------------------------


def test_shard_loop_carries_keeps_values_and_tiles_the_carry():
    w0 = np.random.RandomState(21).rand(256, 64).astype(np.float32)

    def run(st):
        w = st.loop(3, lambda w: w * 0.5 + 1.0, st.from_numpy(
            w0, tiling=_tl(st).replicated(2)))
        r = w.evaluate()
        return r.glom(), r.tiling.axes

    with _meshes((4, 2)):
        off, t_off = run(st_t)
        _, t_jax_off = run(st_j)
        with _flags(shard_loop_carries=True):
            on, t_on = run(st_t)
            _, t_jax_on = run(st_j)
            loop_t = st_t.loop(2, lambda w: w + 1.0, st_t.from_numpy(
                w0, tiling=tiling_t.replicated(2)))
    np.testing.assert_array_equal(on, off)
    assert (t_off, t_on) == (t_jax_off, t_jax_on)
    carry = loop_t.loop.carries[0]
    assert carry.sharded and carry._tiling.axes == ("x", "y")
