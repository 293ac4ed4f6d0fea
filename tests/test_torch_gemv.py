"""The fixed-order vector product (``kernels/gemv.py``) and the
incremental engine's restricted vector products, on the CPU.

The plain version carries the kernel's order (slices of ``KS``, each a
fold in ascending k, the slices folded in order), so a window of its
output is bit-equal to the product of the matching window of the matrix.
It is held to that at odd offsets and widths, with K off a multiple of
``KS``, through transposed views and under ``hypothesis``, and to
float64 numpy and the JAX package's ``jnp.dot(..., precision="highest")``
within the float32 recursive-sum bound ``gamma_n * (|x| @ |A|)`` with
``n = KS + ceil(K / KS) + 1`` roundings on each element's path.

On the CPU ``expr/dot.py`` keeps ``torch.matmul``; the engine cases
monkeypatch ``gemv.routes`` to answer as on the card (a float32 product
of one 1-D and one 2-D operand), so the lowering runs the plain version
and ``expr/incremental.product_granule`` answers 1 for it, with four
torch threads (where the CPU BLAS rule, ``order_granule``, says None).
Edge-insert PageRank (4 batches of 1% of 512 columns) is then served at
every warm step on the 1x1, 8x1 and 4x2 logical meshes, bit-equal to the
flag-off run, with the JAX package's ``incremental_*`` counters and
modes on the same numpy stream, and values within 1e-5 of it (the JAX
package sums in another order). A matrix-matrix product still falls back
under ``contraction-order``; an int32 product is restricted. Gloo worlds
of 2 and 4 CPU processes run the PageRank stream on group meshes: on
(2, 1) and (2, 2) each warm step is served, bit-equal to the one-process
run (each rank's 256 contraction rows are one slice, and two partial
sums add in one commutative add); on (4, 1) the k-split's all-reduce
over a line of four ranks keeps ``contraction-order``, bit-equal to the
group's flag-off run.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.kernels import gemv
from spartan_tpu_torch.parallel import mesh as mesh_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 1), (8, 1), (4, 2)]
U = 2.0 ** -24
N, BATCHES = 512, 4
WIDTH = -(-N // 100)  # 1% of the columns
STARTS = [(j * 7919 * WIDTH) % (N - WIDTH) for j in range(1, BATCHES + 1)]
_COUNTERS = ("incremental_hits", "incremental_fallbacks",
             "incremental_recomputed_tiles")
GROUP_JOIN_S = 240


def _rand(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the plain version's order ---------------------------------------------


@pytest.mark.parametrize("k", [1, 100, gemv.KS, gemv.KS + 1, 845, 1537])
def test_column_windows_are_bit_equal(k):
    x, a = _t(_rand((k,), k)), _t(_rand((k, 301), k + 1))
    full = gemv.fixed_order_dot(x, a)
    for lo, hi in ((0, 301), (1, 2), (3, 40), (17, 300), (255, 258),
                   (299, 301)):
        np.testing.assert_array_equal(
            full[lo:hi].numpy(), gemv.fixed_order_dot(x, a[:, lo:hi]))


@pytest.mark.parametrize("k", [1, 100, gemv.KS, 845, 1537])
def test_row_windows_are_bit_equal(k):
    a, x = _t(_rand((301, k), k + 2)), _t(_rand((k,), k + 3))
    full = gemv.fixed_order_dot(a, x)
    for lo, hi in ((0, 301), (1, 2), (3, 40), (17, 300), (299, 301)):
        np.testing.assert_array_equal(
            full[lo:hi].numpy(), gemv.fixed_order_dot(a[lo:hi], x))


def test_transposed_views_take_the_other_orientation():
    """``x @ B.T`` is ``B @ x`` and ``A.T @ x`` is ``x @ A``: one order,
    so the same bits, and the layout maps each onto the other entry
    point over its base (no copy)."""
    b, x = _t(_rand((203, 845), 7)), _t(_rand((845,), 8))
    np.testing.assert_array_equal(gemv.fixed_order_dot(x, b.t()),
                                  gemv.fixed_order_dot(b, x))
    y = x[:203]
    np.testing.assert_array_equal(gemv.fixed_order_dot(b[:, 5:90].t(), y),
                                  gemv.fixed_order_dot(y, b[:, 5:90]))
    kind, mat, vec, lda = gemv.layout(x, b.t())
    assert (kind, lda) == ("matvec", 845)
    assert mat.data_ptr() == b.data_ptr() and vec is x
    kind, vec, mat, lda = gemv.layout(x, b[:, 5:90].t().t())
    assert (kind, lda) == ("vecmat", 845)
    kind, vec, mat, lda = gemv.layout(y, b[:, ::2])
    assert (kind, lda) == ("vecmat", 423) and mat.is_contiguous()


@settings(max_examples=40, deadline=None)
@given(k=hst.integers(1, 1200), m=hst.integers(1, 90),
       lo=hst.integers(0, 89), w=hst.integers(1, 90),
       seed=hst.integers(0, 2 ** 16))
def test_windows_hypothesis(k, m, lo, w, seed):
    lo = lo % m
    hi = min(m, lo + w)
    x, a = _t(_rand((k,), seed)), _t(_rand((k, m), seed + 1))
    np.testing.assert_array_equal(gemv.fixed_order_dot(x, a)[lo:hi],
                                  gemv.fixed_order_dot(x, a[:, lo:hi]))
    np.testing.assert_array_equal(gemv.fixed_order_dot(a.t(), x)[lo:hi],
                                  gemv.fixed_order_dot(a.t()[lo:hi], x))


def _documented_order(x, a):
    """``x @ a`` in the order the module states, as a float32 numpy loop:
    each slice of ``KS`` rows folded from 0.0 in ascending k (each product
    and each sum rounded to float32 on its own), then the slices' sums
    folded from 0.0 in ascending order."""
    k, m = a.shape
    out = np.zeros(m, np.float32)
    for k0 in range(0, k, 256):
        part = np.zeros(m, np.float32)
        for j in range(k0, min(k, k0 + 256)):
            part = part + x[j] * a[j]
        out = out + part
    return out


@pytest.mark.parametrize("orient", ["vecmat", "matvec"])
@pytest.mark.parametrize("m", [1, 4, 33])
@pytest.mark.parametrize("k", [1, 255, 256, 257, 3 * 256 + 17, 70_000])
def test_plain_order_is_the_documented_loop(k, m, orient):
    """The plain version (the kernel's bits on the card) against an
    independent float32 loop of the documented order, bit for bit, on
    either side of a slice boundary and across many slices."""
    assert gemv.KS == 256
    x, a = _rand((k,), k + m), _rand((k, m), k * m + 1)
    want = _documented_order(x, a)
    assert want.dtype == np.float32
    if orient == "vecmat":
        got = gemv.fixed_order_dot_plain(_t(x), _t(a))
    else:
        got = gemv.fixed_order_dot_plain(_t(a.T), _t(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", [(845, 301), (4096, 64), (7, 1000)])
def test_values_match_float64_and_jax(k, m):
    x, a = _rand((k,), k), _rand((k, m), m)
    got = gemv.fixed_order_dot(_t(x), _t(a)).numpy()
    exact = x.astype(np.float64) @ a.astype(np.float64)
    n = gemv.KS + -(-k // gemv.KS) + 1
    bound = n * U / (1 - n * U) * (np.abs(x).astype(np.float64)
                                   @ np.abs(a).astype(np.float64))
    assert np.all(np.abs(got - exact) <= bound)
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(a),
                              precision="highest"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * float(
        bound.max()))


def test_empty_contraction_and_bad_operands():
    np.testing.assert_array_equal(
        gemv.fixed_order_dot(torch.zeros(0), torch.zeros(0, 5)),
        np.zeros(5, np.float32))
    with pytest.raises(ValueError):
        gemv.fixed_order_dot(torch.zeros(3, 4), torch.zeros(4, 5))
    with pytest.raises(TypeError):
        gemv.fixed_order_dot(torch.zeros(4, dtype=torch.float64),
                             torch.zeros(4, 5, dtype=torch.float64))


def test_routes_only_on_the_card():
    v, m = torch.zeros(4), torch.zeros(4, 5)
    assert gemv.takes(v, m, np.float32) and gemv.takes(m.t(), v, "float32")
    assert not gemv.routes(v, m, np.float32)  # a CPU tensor
    meta = torch.zeros(4, 5, device="meta")
    assert not gemv.routes(meta[0], meta, np.float32)
    assert not gemv.takes(m, m.t(), np.float32)  # matrix-matrix
    assert not gemv.takes(v, v, np.float32)
    assert not gemv.takes(v, m, np.float64)
    assert not gemv.takes(v, m, np.int32)


# -- the operator -----------------------------------------------------------


def test_operator_batching_rule_is_a_loop_of_solo_calls():
    xs, a = _t(_rand((5, 845), 1)), _t(_rand((845, 77), 2))
    got = torch.func.vmap(gemv.fixed_order_dot, in_dims=(0, None))(xs, a)
    want = torch.stack([gemv.fixed_order_dot(x, a) for x in xs])
    np.testing.assert_array_equal(got, want)
    bs = _t(_rand((3, 60, 845), 3))
    got = torch.func.vmap(gemv.fixed_order_dot, in_dims=(0, 0))(bs, xs[:3])
    want = torch.stack([gemv.fixed_order_dot(b, x)
                        for b, x in zip(bs, xs[:3])])
    np.testing.assert_array_equal(got, want)


def test_operator_shape_rule_on_meta():
    x = torch.empty(845, device="meta")
    a = torch.empty(845, 77, device="meta")
    assert gemv.fixed_order_dot(x, a).shape == (77,)
    assert gemv.fixed_order_dot(a.t(), x).shape == (77,)
    out = torch.ops.spartan_tpu_torch.fixed_order_dot(x, a)
    assert out.device.type == "meta" and out.shape == (77,)


# -- the engine with the route on -------------------------------------------


def _pkg(name):
    import importlib

    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, st=st_j if name == "spartan_tpu" else st_t,
        base=m("expr.base"), inc=m("expr.incremental"),
        prof=m("utils.profiling"), FLAGS=m("utils.config").FLAGS,
        streaming=m("examples.streaming"), da=m("array.distarray"),
        lazify=m("expr.base").lazify, evaluate=m("expr.base").evaluate)


J = _pkg("spartan_tpu")
T = _pkg("spartan_tpu_torch")


@pytest.fixture()
def routed(monkeypatch):
    """The port on the CPU with the card's route and four torch threads;
    counts the plain version's calls."""
    prev_dev, prev_threads = mesh_t.get_default_device(), \
        torch.get_num_threads()
    mesh_t.set_default_device("cpu")
    torch.set_num_threads(4)
    calls = [0]
    plain = gemv.fixed_order_dot_plain

    def counted(a, b):
        calls[0] += 1
        return plain(a, b)

    monkeypatch.setattr(gemv, "routes",
                        lambda a, b, dtype: gemv.takes(a, b, dtype))
    monkeypatch.setattr(gemv, "fixed_order_dot_plain", counted)
    saved = (T.FLAGS.incremental, J.FLAGS.incremental)
    try:
        yield calls
    finally:
        T.FLAGS.incremental, J.FLAGS.incremental = saved
        T.inc.clear()
        J.inc.clear()
        torch.set_num_threads(prev_threads)
        mesh_t.set_default_device(prev_dev)


def _use(P, shape):
    if P is J:
        n = shape[0] * shape[1]
        return mesh_j.use_mesh(mesh_j.build_mesh(jax.devices()[:n],
                                                 shape=shape))
    return mesh_t.use_mesh(mesh_t.build_mesh(shape))


def _counts(P):
    c = P.prof.counters()
    return {k: int(c.get(k, 0)) for k in _COUNTERS}


def _mode(P, expr):
    plan = P.base.lookup_plan(P.base.plan_signature(expr)[0])
    inc = (plan.report or {}).get("incremental") or {}
    return inc.get("mode"), inc.get("fallback")


def _stream(P, shape, on, first, updates, build, const):
    """``build(P, arr, c)`` over the array ``first`` and after each of
    ``updates`` ((region, values) writes), with ``c`` the array of
    ``const`` (made once), the flag on or off: the warm results, the
    counter deltas and each warm evaluate's mode."""
    P.FLAGS.incremental = on
    P.inc.clear()
    with _use(P, shape):
        arr = P.st.from_numpy(first).evaluate()
        c = P.st.from_numpy(const).evaluate()
        P.evaluate(build(P, arr, c))
        c0 = _counts(P)
        outs, modes = [], []
        for region, vals in updates:
            arr = arr.update(region, vals)
            outs.append(np.asarray(P.evaluate(build(P, arr, c)).glom()))
            modes.append(_mode(P, build(P, arr, c)))
        c1 = _counts(P)
    P.inc.clear()
    return outs, {k: c1[k] - c0[k] for k in _COUNTERS}, modes


def _pagerank(P, shape, on):
    """Edge-insert PageRank through ``IncrementalPageRank``: BATCHES
    batches of WIDTH columns, a step after each."""
    P.FLAGS.incremental = on
    P.inc.clear()
    rng = np.random.RandomState(60)
    a = rng.rand(N, N).astype(np.float32)
    a /= a.sum(1, keepdims=True)
    with _use(P, shape):
        pr = P.streaming.IncrementalPageRank(P.st.from_numpy(a).evaluate(),
                                             rebase_every=BATCHES + 1)
        pr.step()
        c0 = _counts(P)
        outs, modes = [], []
        for j in STARTS:
            pr.insert_edges(slice(j, j + WIDTH),
                            rng.rand(N, WIDTH).astype(np.float32) / N)
            outs.append(np.asarray(pr.step().glom()))
            modes.append(_mode(P, pr._step_expr()))
        c1 = _counts(P)
    P.inc.clear()
    return outs, {k: c1[k] - c0[k] for k in _COUNTERS}, modes


def _check_served(on, off, jax_on, steps, tol=1e-5):
    outs, counts, modes = on
    assert counts["incremental_hits"] == steps, counts
    assert counts["incremental_fallbacks"] == 0, counts
    assert modes == [("incremental", None)] * steps
    for got, want in zip(outs, off[0]):
        np.testing.assert_array_equal(got, want)
    assert counts == jax_on[1]
    assert modes == jax_on[2]
    for got, want in zip(outs, jax_on[0]):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", MESHES)
def test_pagerank_warm_steps_are_served_as_in_jax(shape, routed):
    """Each warm step's product restricted to the rewritten columns (one
    plain call a step), bit-equal to the flag-off run, the JAX package's
    counters and modes; without the route the same stream falls back."""
    assert T.inc.order_granule(torch.device("cpu")) is None
    on = _pagerank(T, shape, True)
    assert routed[0] == BATCHES + 1  # the cold step and each warm one
    off = _pagerank(T, shape, False)
    _check_served(on, off, _pagerank(J, shape, True), BATCHES)


def test_pagerank_without_the_route_falls_back(routed, monkeypatch):
    monkeypatch.setattr(gemv, "routes", lambda a, b, dtype: False)
    outs, counts, modes = _pagerank(T, (8, 1), True)
    assert counts["incremental_fallbacks"] == BATCHES
    assert modes == [("full", "contraction-order")] * BATCHES
    assert routed[0] == 0
    for got, want in zip(outs, _pagerank(T, (8, 1), False)[0]):
        np.testing.assert_array_equal(got, want)


def _matvec(P, arr, x):
    return P.lazify(arr).dot(P.lazify(x)) * 2.0 + 1.0


_MATVEC_UPDATES = [((slice(r, r + 7), slice(0, 384)), _rand((7, 384), r))
                   for r in (3, 200, 501)]


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_matrix_vector_row_stream_is_served(shape, routed):
    args = (_rand((512, 384), 62), _MATVEC_UPDATES, _matvec,
            _rand((384,), 61))
    on = _stream(T, shape, True, *args)
    assert routed[0] == 1 + len(_MATVEC_UPDATES)
    _check_served(on, _stream(T, shape, False, *args),
                  _stream(J, shape, True, *args), len(_MATVEC_UPDATES))


def _matmat(P, arr, b):
    return P.lazify(arr).dot(P.lazify(b))


def test_matrix_matrix_product_keeps_contraction_order(routed):
    args = (_rand((512, 384), 64), _MATVEC_UPDATES, _matmat,
            _rand((384, 96), 63))
    outs, counts, modes = _stream(T, (8, 1), True, *args)
    assert counts["incremental_fallbacks"] == len(_MATVEC_UPDATES)
    assert modes == [("full", "contraction-order")] * len(_MATVEC_UPDATES)
    assert routed[0] == 0
    for got, want in zip(outs, _stream(T, (8, 1), False, *args)[0]):
        np.testing.assert_array_equal(got, want)


def _int_product(P, arr, v):
    return P.lazify(v).dot(P.lazify(arr))


def test_int32_product_is_restricted_in_any_order(routed):
    rng = np.random.RandomState(65)
    first = rng.randint(-50, 50, (512, 384)).astype(np.int32)
    updates = [((slice(0, 512), slice(c, c + 5)),
                rng.randint(-50, 50, (512, 5)).astype(np.int32))
               for c in (1, 190, 379)]
    args = (first, updates, _int_product,
            (np.arange(512) % 7 - 3).astype(np.int32))
    on = _stream(T, (8, 1), True, *args)
    _check_served(on, _stream(T, (8, 1), False, *args),
                  _stream(J, (8, 1), True, *args), len(updates), tol=0)


# -- group meshes ------------------------------------------------------------

_GROUP_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(2)
import torch.distributed as dist
import spartan_tpu_torch as st
from spartan_tpu_torch.examples import streaming
from spartan_tpu_torch.expr import base, incremental
from spartan_tpu_torch.kernels import gemv
from spartan_tpu_torch.parallel import mesh as mesh_mod
from spartan_tpu_torch.utils import profiling as prof
from spartan_tpu_torch.utils.config import FLAGS

gemv.routes = lambda a, b, dtype: gemv.takes(a, b, dtype)
st.set_default_device("cpu")
assert st.initialize_distributed() is True
shape = tuple(json.loads(os.environ["SHAPE"]))
mesh = mesh_mod.Mesh(shape, torch.device("cpu"), group=dist.group.WORLD)
n, starts, width = int(os.environ["N"]), json.loads(os.environ["STARTS"]), \
    int(os.environ["WIDTH"])


def counts():
    c = prof.counters()
    return [int(c.get(k, 0)) for k in ("incremental_hits",
                                       "incremental_fallbacks")]


def mode(expr):
    plan = base.lookup_plan(base.plan_signature(expr)[0])
    inc = (plan.report or {}).get("incremental") or {}
    return [inc.get("mode"), inc.get("fallback")]


arrays, facts = {}, {}
with mesh_mod.use_mesh(mesh):
    for on in (True, False):
        FLAGS.incremental = on
        incremental.clear()
        rng = np.random.RandomState(60)
        a = rng.rand(n, n).astype(np.float32)
        a /= a.sum(1, keepdims=True)
        pr = streaming.IncrementalPageRank(st.from_numpy(a).evaluate(),
                                           rebase_every=len(starts) + 1)
        pr.step()
        c0, modes = counts(), []
        for i, j in enumerate(starts):
            pr.insert_edges(slice(j, j + width),
                            rng.rand(n, width).astype(np.float32) / n)
            arrays[f"{on}/{i}"] = np.asarray(pr.step().glom())
            modes.append(mode(pr._step_expr()))
        facts[str(on)] = [[x - y for x, y in zip(counts(), c0)], modes]
FLAGS.incremental = False
incremental.clear()
st.shutdown()
out = os.environ["OUT"]
np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(facts, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


@functools.lru_cache(maxsize=None)
def _group_run(shape):
    """Every rank's (arrays, facts) of _GROUP_CHILD on a gloo group of
    the mesh ``shape``."""
    world = shape[0] * shape[1]
    tmp = tempfile.mkdtemp(prefix="gemv_group_")
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, OUT=tmp, SHAPE=json.dumps(shape),
                   N=str(N), STARTS=json.dumps(STARTS), WIDTH=str(WIDTH),
                   COORDINATOR_ADDRESS=f"file://{tmp}/store",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="2")
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


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_group_pagerank_is_served_bit_equal_to_one_process(shape, routed):
    """Lines of two ranks: every warm step served on every rank,
    bit-equal to the group's flag-off run and to the one-process run."""
    one = _pagerank(T, (1, 1), True)[0]
    for arrays, facts in _group_run(shape):
        assert facts["True"][0] == [BATCHES, 0]
        assert facts["True"][1] == [["incremental", None]] * BATCHES
        assert facts["False"][0] == [0, 0]
        for i in range(BATCHES):
            np.testing.assert_array_equal(arrays[f"True/{i}"],
                                          arrays[f"False/{i}"])
            np.testing.assert_array_equal(arrays[f"True/{i}"], one[i])


def test_group_line_of_four_keeps_contraction_order(routed):
    """A (4, 1) world: the product's k-split all-reduce runs over a line
    of four ranks, so every warm step falls back under
    ``contraction-order`` on every rank, bit-equal to the flag-off run
    and within 1e-6 of the one-process run."""
    one = _pagerank(T, (1, 1), True)[0]
    for arrays, facts in _group_run((4, 1)):
        assert facts["True"][0] == [0, BATCHES]
        assert facts["True"][1] == [["full", "contraction-order"]] * BATCHES
        for i in range(BATCHES):
            np.testing.assert_array_equal(arrays[f"True/{i}"],
                                          arrays[f"False/{i}"])
            np.testing.assert_allclose(arrays[f"True/{i}"], one[i],
                                       rtol=1e-6, atol=1e-6)
