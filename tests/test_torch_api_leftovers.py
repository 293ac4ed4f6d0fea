"""The API leftovers of the port's ported files, each against the JAX
function on the same inputs, on the CPU: the extent algebra
(``TileExtent.to_global``/``to_local``/``ravelled_pos``/``drop_axis``/
``add_axis``, ``create``, ``from_shape``, ``find_overlapping``,
``all_nonoverlapping``, ``is_complete``, ``tiles_like_hint``,
``index_for``), the flag registry's ``reset_all``,
``snapshot_nondefault``, ``define_int_list``, ``Flag.parse`` and
``Flag.reset``, ``Expr.optimized`` and ``Expr.recompute``,
``classify.retryable``, ``DistArray.tile_shape`` and
``Tiling.mesh_axis_of``, and the rest of ``utils/log.py`` (``log_error``,
``divup``, ``Assert``, ``Timer``, ``timer_ctx``). Everything is exact."""

import logging

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import distarray as da_j
from spartan_tpu.array import extent as ext_j
from spartan_tpu.array import tiling as til_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.resilience import classify as cls_j
from spartan_tpu.utils import config as cfg_j
from spartan_tpu.utils import log as log_j
from spartan_tpu_torch.array import distarray as da_t
from spartan_tpu_torch.array import extent as ext_t
from spartan_tpu_torch.array import tiling as til_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import classify as cls_t
from spartan_tpu_torch.utils import config as cfg_t
from spartan_tpu_torch.utils import log as log_t

torch.set_num_threads(1)
MESHES = [(4, 2), (8, 1)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _e(e):
    return None if e is None else (e.ul, e.lr, e.array_shape)


# -- the extent algebra --------------------------------------------------


@pytest.mark.parametrize("ul,lr,shape", [
    ((2, 3), (5, 7), (8, 9)), ((0,), (4,), (4,)), ((1, 0, 2), (3, 4, 5),
                                                   (3, 4, 6))])
def test_extent_conversions_match_jax(ul, lr, shape):
    for mod in (ext_j, ext_t):
        assert _e(mod.create(ul, lr, shape)) == (ul, lr, shape)
    ej, et = ext_j.create(ul, lr, shape), ext_t.create(ul, lr, shape)
    local = tuple(range(len(ul)))
    assert et.to_global(local) == ej.to_global(local)
    assert et.to_local(lr) == ej.to_local(lr)
    assert et.ravelled_pos() == ej.ravelled_pos()
    for ax in range(-len(ul), len(ul)):
        if len(ul) > 1:
            assert _e(et.drop_axis(ax)) == _e(ej.drop_axis(ax))
    for ax in range(-len(ul) - 1, len(ul) + 1):
        assert _e(et.add_axis(ax, 3)) == _e(ej.add_axis(ax, 3))
    assert _e(ext_t.from_shape(shape)) == _e(ext_j.from_shape(shape))
    with pytest.raises(ValueError):
        ext_t.TileExtent(ul, lr).ravelled_pos()


@pytest.mark.parametrize("shape,hint", [((10, 7), (4, 3)), ((16,), (5,)),
                                        ((6, 6, 6), (2, 6, 4))])
def test_tile_map_algebra_matches_jax(shape, hint):
    tj, tt = ext_j.tiles_like_hint(shape, hint), ext_t.tiles_like_hint(
        shape, hint)
    assert [_e(e) for e in tt] == [_e(e) for e in tj]
    assert ext_t.is_complete(shape, tt) and ext_j.is_complete(shape, tj)
    assert ext_t.all_nonoverlapping(tt)
    region_t = ext_t.create(tuple(1 for _ in shape),
                            tuple(min(4, s) for s in shape), shape)
    region_j = ext_j.create(region_t.ul, region_t.lr, shape)
    assert ([_e(e) for e in ext_t.find_overlapping(tt, region_t)]
            == [_e(e) for e in ext_j.find_overlapping(tj, region_j)])
    over = tt + [tt[0]]
    assert not ext_t.all_nonoverlapping(over)
    assert not ext_t.is_complete(shape, over)
    assert not ext_j.is_complete(shape, tj + [tj[0]])
    it, ij = ext_t.index_for(tt), ext_j.index_for(tj)
    assert sorted((_e(k), v) for k, v in it.items()) == \
        sorted((_e(k), v) for k, v in ij.items())


# -- the flag registry ----------------------------------------------------


def _flag_story(cfg, env_prefix, monkeypatch):
    monkeypatch.setenv(env_prefix + "LEFTOVER_ENV", "7")
    reg = cfg.FlagRegistry()
    a = reg.define_int("leftover_a", 3)
    reg.define_int("leftover_env", 1)
    lst = reg.define_int_list("leftover_list", [1, 2])
    reg.define_bool("leftover_b", False)
    out = [reg.snapshot_nondefault(), "leftover_a" in reg,
           sorted(f.name for f in reg)]
    a.parse("11")
    lst.parse("4,5,,6")
    reg.leftover_b = True
    out += [reg.leftover_a, reg.leftover_list, reg.snapshot_nondefault()]
    m0 = cfg.mutation_count()
    a.reset()
    out += [reg.leftover_a, cfg.mutation_count() > m0]
    reg.parse_args(["--leftover_list=9,8", "--leftover_a", "5"])
    out += [reg.leftover_list, reg.leftover_a]
    reg.reset_all()
    out += [reg.snapshot(), reg.snapshot_nondefault()]
    return out


def test_flag_registry_leftovers_match_jax(monkeypatch):
    got_j = _flag_story(cfg_j, "SPARTAN_TPU_", monkeypatch)
    got_t = _flag_story(cfg_t, "SPARTAN_TPU_TORCH_", monkeypatch)
    assert got_t == got_j
    # reset restores the value as configured (the environment's 7)
    assert got_t[-2]["leftover_env"] == 7
    assert got_t[-1] == {"leftover_env": 7}


# -- Expr.optimized / Expr.recompute ---------------------------------------


def _chain(st, x):
    return ((st.as_expr(x) * 2.0 + 1.0) - 0.5).sum(axis=0)


def _kinds(root):
    seen, out, stack = set(), [], [root]
    while stack:
        n = stack.pop()
        if n._id in seen:
            continue
        seen.add(n._id)
        out.append(type(n).__name__)
        stack.extend(n.children())
    return sorted(out)


@pytest.mark.parametrize("mesh", MESHES)
def test_optimized_and_recompute_match_jax(mesh):
    x = np.random.RandomState(3).rand(32, 16).astype(np.float32)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        ej = _chain(st_j, x)
        kj = _kinds(ej.optimized())
        r1j = ej.evaluate()
        r2j = ej.recompute()
        vj = r2j.glom()
        assert r2j is not r1j
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        et = _chain(st_t, x)
        kt = _kinds(et.optimized())
        assert et._result is None  # optimizing evaluates nothing
        r1t = et.evaluate()
        r2t = et.recompute()
        assert r2t is not r1t and et._result is r2t
        assert np.array_equal(r2t.glom(), r1t.glom())
    assert kt == kj
    np.testing.assert_allclose(r2t.glom(), vj, rtol=1e-6)


# -- classify.retryable ---------------------------------------------------


def test_retryable_matches_jax():
    cases = [RuntimeError("UNAVAILABLE: socket closed (transient)"),
             RuntimeError("deadline exceeded while waiting"),
             OSError("disk gone"), ValueError("bad shape"),
             MemoryError("out of memory"),
             RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
             RuntimeError("INTERNAL: device lost"),
             RuntimeError("integrity violation on device 3")]
    for exc in cases:
        assert cls_t.retryable(exc) == cls_j.retryable(exc), exc
    assert cls_t.retryable(OSError("x")) is True
    assert cls_t.retryable(ValueError("x")) is False


# -- DistArray.tile_shape / Tiling.mesh_axis_of ----------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape,axes", [((64, 48), ("x", "y")),
                                        ((63, 33), ("x", None)),
                                        ((64,), ("y",)),
                                        ((10, 8), (None, None))])
def test_tile_shape_and_mesh_axis_of_match_jax(mesh, shape, axes):
    a = np.zeros(shape, np.float32)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        tj = til_j.Tiling(axes)
        if mesh[1] == 1:
            tj = til_j.Tiling(tuple(None if v == "y" else v for v in axes))
        try:
            want = da_j.from_numpy(a, tiling=tj).tile_shape()
        except ValueError:
            want = "refused"
    tt = til_t.Tiling(tj.axes)
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        got = da_t.from_numpy(a, tiling=tt).tile_shape()
    if want != "refused":  # the port tiles uneven shapes too (C31)
        assert tuple(got) == tuple(want)
    for ax in range(len(shape)):
        assert tt.mesh_axis_of(ax) == tj.mesh_axis_of(ax)


# -- utils/log.py -----------------------------------------------------------


def test_log_helpers_match_jax(caplog):
    for a, b in ((7, 2), (8, 2), (0, 3), (1, 1)):
        assert log_t.divup(a, b) == log_j.divup(a, b)
    for A in (log_t.Assert, log_j.Assert):
        A.all_eq([1, 2], np.array([1, 2]))
        A.all_eq([1.0, 2.0], [1.0, 2.0 + 1e-9], tol=1e-6)
        A.all_close([1.0], [1.0 + 1e-7])
        A.eq(3, 3)
        A.true(1)
        A.isinstance_(1, int)
        for bad in (lambda: A.all_eq([1, 2], [1, 3]),
                    lambda: A.all_eq([1], [1, 2]), lambda: A.eq(1, 2),
                    lambda: A.true(0, "no"),
                    lambda: A.isinstance_("s", int)):
            with pytest.raises(AssertionError):
                bad()
    for mod in (log_t, log_j):
        t = mod.Timer()
        for _ in range(3):
            with t.measure():
                pass
        assert t.count == 3 and t.elapsed >= 0.0 and t.mean >= 0.0
        assert mod.Timer().mean == 0.0
    with caplog.at_level(logging.INFO, logger="spartan_tpu_torch"):
        with log_t.timer_ctx("leftover-span"):
            pass
        log_t.log_error("leftover %d", 42)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "spartan_tpu_torch"]
    assert any(m.startswith("leftover-span: ") and m.endswith(" ms")
               for m in msgs)
    assert "leftover 42" in msgs


@pytest.mark.parametrize("ndim", [0, 1, 2, 3])
def test_flat_row_matches_jax(ndim):
    """``tiling.flat_row``: the leading axis over both mesh axes; the
    same axes, and on each mesh the same tile extents."""
    assert til_t.flat_row(ndim).axes == til_j.flat_row(ndim).axes
    shape = (16, 6, 4)[:ndim]
    for m in MESHES:
        mj = mesh_j.build_mesh(jax.devices(), shape=m)
        mt = mesh_t.build_mesh(m, "cpu")
        want = [(e.ul, e.lr) for e in til_j.flat_row(ndim).extents(shape,
                                                                   mj)]
        got = [(e.ul, e.lr) for e in til_t.flat_row(ndim).extents(shape,
                                                                  mt)]
        assert got == want


def test_count_ops_matches_jax():
    """``expr.local.count_ops`` on the fused trees of the same maps,
    and its TypeError on a node that is no tree."""
    from spartan_tpu.expr import local as loc_j
    from spartan_tpu_torch.expr import local as loc_t

    def trees(st, loc):
        x = st.from_numpy(np.ones((4, 4), np.float32))
        exprs = [x + 1.0, st.exp(x * 2.0 - x), st.sqrt(abs(x)) / (x + 3.0),
                 (x * x).astype(np.int32)]
        out = []
        for e in exprs:
            op = e.optimized().op
            out.append(loc.count_ops(op))
        out.append(loc.count_ops(loc.LocalInput(0)))
        out.append(loc.count_ops(loc.LocalConst(2.0)))
        with pytest.raises(TypeError):
            loc.count_ops(object())
        return out

    got = trees(st_t, loc_t)
    assert got == trees(st_j, loc_j)
    assert got[:4] == [1, 3, 4, 2]
