"""Local-shard storage on a group mesh: each rank holds only its blocks.

Gloo groups of 2 and 4 CPU processes (meshes 2x1 and 2x2), launched as
tests/test_torch_distributed.py launches them: a ``file://`` store under
``tmp_path`` and one child run per world size that does every case. The
children import torch and the port only. Each case's result is held
against the JAX package on the 8-device CPU mesh cut to the group's
shape, and against the port's logical mesh of that shape (the same
cases, run here in the parent).

The cases: ``from_numpy``/``glom`` round trips under even and uneven
tilings, each rank's ``local`` of exactly its extent's shape and bytes
(and ``shape``/``dtype``/``ndim``/``size`` calling no collective);
map, map2 (``shard_map2``) and reduce (``sum``, ``max``, ``argmax``,
``mean``, ``min``, ``argmin``) along each axis; ``dot`` under forced
plans of each strategy (a k-split must all-reduce); an ``einsum``
through ``ContractExpr`` under its committed plan and forced ones; ``retile`` through every pair of layouts;
``st.loop``; config-3-shaped k-means; the sample sort and argsort; the
top-k with ties and with C4's NaN keys; PageRank over the sharded SpMV;
``update``, ``fetch`` and donation; the group forms of the bincount,
segment-sum, k-means and stencil kernels on the stored blocks and on
whole tensors (each rank keeps its block); a transpose, which permutes
each rank's block and gathers nothing; and ``map2`` with a user
function proven row-partitionable (``expr/partition.py``), which runs
on the ranks' row blocks and gathers nothing. On the main-path cases
``group_materialize_calls`` stays 0. ``calibrate_flop_weight`` gives
every rank the same weight. The user-function cases (``_PART_CASES``)
hold the regression, SVM, fuzzy k-means and k-means steps, the predict
kernels and elementwise maps against the JAX package's same functions:
0 gathered, one all-reduce a step; unproven functions keep their
counted gather.

Tolerances: data movement, sort, top-k and integer sums bit-equal;
float sums and ``map2`` 1e-6 relative (XLA fuses ``a * b + b`` into
one rounding); GEMMs 1e-4 relative (the k-split changes the order of
the sum); k-means centers and steps rtol 2e-5 (atol 1e-6); PageRank
1e-6 of the largest rank; the stencil rtol 1e-4 / atol 1e-5 against
the JAX package and 1e-5 / 1e-6 against the logical mesh. C12's
NaN-in-max, C13's unique and C30's negative powers stay out of the
cases.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.array.sparse import SparseDistArray as SpJ
from spartan_tpu.examples.pagerank import pagerank as pagerank_j
from spartan_tpu.kernels import histogram as khist_j
from spartan_tpu.kernels import kmeans as kk_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.kernels import segment as kseg_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 150

# The port's side of every case, run by each rank of a group and, in the
# parent, on a logical mesh of the group's shape. Defines
# run_cases(inputs) -> (results, materializations per main-path case).
_PORT_CASES = r'''
import numpy as np
import torch
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.sparse import SparseDistArray
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.examples.pagerank import pagerank
from spartan_tpu_torch.obs.metrics import collective_totals

LAYOUTS = {"row": ("x", None), "col": (None, "y"), "block": ("x", "y"),
           "block_t": ("y", "x"), "rep": (None, None),
           "flat": (("x", "y"), None), "row_t": ("y", None)}
PLANS = [(("x", None), None), ((None, "x"), None), (("x", "y"), None),
         (("y", "x"), None), ((None, None), "x"), ((None, None), "y"),
         (("x", None), "y"), ((None, "y"), "x")]


def run_cases(inputs):
    out, mat = {}, {}
    mesh = st.get_mesh()

    def count(key):
        return collective_totals()[key]

    def main(name, fn):
        before = count("group_materialize_calls")
        out[name] = fn()
        mat[name] = count("group_materialize_calls") - before

    a = inputs["rt"]
    for name, axes in LAYOUTS.items():
        d = from_numpy(a, tiling=Tiling(axes))
        calls = count("collective_calls")
        meta = (d.shape, d.dtype, d.ndim, d.size)
        out[f"meta_calls_{name}"] = np.array(count("collective_calls")
                                             - calls)
        assert meta == (a.shape, np.dtype(np.float32), 2, a.size)
        out[f"local_shape_{name}"] = np.array(d.local.shape)
        out[f"local_bytes_{name}"] = np.array(
            d.local.numel() * d.local.element_size())
        main(f"rt_{name}", d.glom)

    x = st.as_expr(from_numpy(inputs["x"]))
    y = st.as_expr(from_numpy(inputs["y"], tiling=Tiling((None, "y"))))
    v = st.as_expr(from_numpy(inputs["v"]))
    main("map_add", lambda: (x + y).glom())
    main("map_bcast", lambda: (x * v + 1.0).glom())
    main("map_exp", lambda: st.exp(x - y).glom())
    main("smap2", lambda: st.shard_map2(
        [x, v], lambda b, w: b * w, (Tiling(("x", None)), Tiling((None,))),
        Tiling(("x", None)), x.shape).glom())
    xi = st.as_expr(from_numpy(inputs["xi"]))
    for op in ("sum", "max", "argmax", "mean", "min", "argmin"):
        for axis in (None, 0, 1):
            main(f"red_{op}_{axis}",
                 lambda: getattr(x, op)(axis=axis).glom())
    for axis in (None, 0, 1):
        main(f"ired_{axis}", lambda: xi.sum(axis=axis).glom())
    main("astype_sum", lambda: (xi.astype(np.float32) * x).sum(
        axis=0).glom())

    A = st.as_expr(from_numpy(inputs["A"]))
    B = st.as_expr(from_numpy(inputs["B"], tiling=Tiling((None, "x"))))
    st.FLAGS.opt_auto_tiling = False
    try:
        for i, (axes, k) in enumerate(PLANS):
            e = st.dot(A, B)
            e._dot_plan = (Tiling(axes), k)
            calls = count("collective_calls")
            main(f"dot_{i}", e.glom)
            out[f"dot_calls_{i}"] = np.array(count("collective_calls")
                                             - calls)
        main("dot_noplan", lambda: st.dot(A, B).glom())
        main("matvec", lambda: st.dot(A, st.as_expr(
            from_numpy(inputs["B"][:, 0]))).glom())
    finally:
        st.FLAGS.opt_auto_tiling = True
    main("dot_planned", lambda: st.dot(A, B).glom())
    P = st.as_expr(from_numpy(inputs["P"]))
    Q = st.as_expr(from_numpy(inputs["Q"]))
    main("einsum", lambda: st.einsum("bij,bjk->bik", P, Q).glom())
    st.FLAGS.opt_auto_tiling = False
    try:
        for i, plan in enumerate([(("x", None, None), None),
                                  ((None, None, None), "x")]):
            e = st.einsum("bij,bjk->bik", P, Q)
            assert type(e).__name__ == "ContractExpr"
            e._dot_plan = (Tiling(plan[0]), plan[1])
            calls = count("collective_calls")
            main(f"einsum_{i}", e.glom)
            out[f"einsum_calls_{i}"] = np.array(count("collective_calls")
                                                - calls)
    finally:
        st.FLAGS.opt_auto_tiling = True

    R = inputs["R"]
    for s_name, s_axes in LAYOUTS.items():
        src = from_numpy(R, tiling=Tiling(s_axes))
        for d_name, d_axes in LAYOUTS.items():
            got = count("group_received_bytes")
            r = src.retile(Tiling(d_axes))
            out[f"retile_shape_{s_name}_{d_name}"] = np.array(r.local.shape)
            out[f"retile_recv_{s_name}_{d_name}"] = np.array(
                count("group_received_bytes") - got)
            main(f"retile_{s_name}_{d_name}", r.glom)

    main("loop", lambda: st.loop(3, lambda c: c * 0.5 + x, x).glom())

    pts = st.as_expr(from_numpy(inputs["km_pts"]))
    c0 = inputs["km_c0"]
    k = c0.shape[0]
    main("km_loop", lambda: st.loop(
        4, lambda c: km.kmeans_step(pts, c, k), from_numpy(c0)).glom())
    out["km_centers"], out["km_assign"] = km.kmeans(
        pts, k, num_iter=4, centers=c0)

    for flag in ("on", "off"):  # the packing kernel, the scatter
        st.FLAGS.native_kernels = flag
        try:
            for name in ("keys", "keys_odd", "ties"):
                kx = st.as_expr(from_numpy(inputs[name]))
                main(f"sort_{flag}_{name}", lambda: st.sort(kx).glom())
                main(f"argsort_{flag}_{name}",
                     lambda: st.argsort(kx).glom())
        finally:
            st.FLAGS.native_kernels = "auto"
    for flag in ("on", "off"):
        st.FLAGS.native_kernels = flag
        try:
            for name, kk in (("ties", 5), ("keys_odd", 6), ("nan", 7)):
                kx = st.as_expr(from_numpy(inputs[name]))
                for largest in (True, False):
                    vals, idx = st.topk(kx, kk, largest=largest)
                    key = f"topk_{flag}_{name}_{largest}"
                    main(key + "_v", vals.glom)
                    main(key + "_i", idx.glom)
        finally:
            st.FLAGS.native_kernels = "auto"

    rows, cols = inputs["pr_rows"], inputs["pr_cols"]
    n = int(inputs["pr_n"])
    links = SparseDistArray.from_coo(rows, cols,
                                     np.ones(rows.shape[0], np.float32),
                                     (n, n))
    main("pagerank", lambda: pagerank(links, num_iter=20))

    U = from_numpy(R, tiling=Tiling(("x", "y")))
    region = (slice(3, 11), slice(2, 9))
    main("update_add", lambda: U.update(region, 7.0, "add").glom())
    main("update_set", lambda: U.update(region, inputs["upd"]).glom())
    main("fetch", lambda: U.fetch((slice(5, 14), slice(1, 12))))
    D = from_numpy(R, tiling=Tiling(("x", None)))
    main("donate", lambda: (st.as_expr(D) * 2.0).evaluate(
        donate=[D]).glom())
    out["donated"] = np.array(D.is_donated)
    try:
        D.glom()
        out["donated_raises"] = np.array(False)
    except RuntimeError:
        out["donated_raises"] = np.array(True)

    # the group forms of rows 3, 4 and 7 on the blocks the ranks store
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import segment as ks

    ids = inputs["seg_ids"]
    main("bincount", lambda: st.bincount(
        st.as_expr(from_numpy(inputs["hist_ids"])), length=64).glom())
    main("bincount_sharded", lambda: kh.bincount_sharded(
        from_numpy(inputs["hist_ids"]), 64).numpy())
    for kseg in (12, 16):
        main(f"segment_{kseg}", lambda: ks.segment_sum_sharded(
            from_numpy(inputs["seg_vals"], tiling=Tiling(("x", None))),
            from_numpy(ids, tiling=Tiling(("x",))), kseg).numpy())
    st.FLAGS.native_kernels = "on"
    try:
        img = from_numpy(inputs["st_img"], tiling=Tiling((None, "x", None,
                                                          None)))
        main("stencil", lambda: st.stencil(st.as_expr(img), st.as_expr(
            from_numpy(inputs["st_flt"]))).glom())
    finally:
        st.FLAGS.native_kernels = "auto"

    # the same kernels' wrappers given whole tensors: on a group mesh
    # each rank keeps its block of them
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.kernels import stencil as kst

    main("bincount_tensor", lambda: kh.bincount_sharded(
        torch.from_numpy(inputs["hist_ids"]), 64).numpy())
    for kseg in (12, 16):
        main(f"segment_tensor_{kseg}", lambda: ks.segment_sum_sharded(
            torch.from_numpy(inputs["seg_vals"]), torch.from_numpy(ids),
            kseg).numpy())
    main("km_step_tensor", lambda: kk.step(
        torch.from_numpy(inputs["km_pts"]), torch.from_numpy(c0),
        k).numpy())
    main("stencil_tensor", lambda: kst.halo_stencil(
        torch.from_numpy(inputs["st_img"]), torch.from_numpy(
            inputs["st_flt"]), Tiling((None, "x", None, None))).numpy())

    from spartan_tpu_torch.expr import tiling_cost as tc

    # one weight on every rank (the cross-rank check below)
    out["flop_weight"] = np.array(tc.calibrate_flop_weight(32, iters=1))

    main("transpose", lambda: x.T.glom())
    before = count("group_materialize_calls")
    out["map2"] = st.map2([x, y], lambda a, b: a * b + b).glom()
    out["map2_gathers"] = np.array(count("group_materialize_calls") - before)
    return out, mat
'''

# The local rules of the structure ops, outer, the blocked scan, user
# reduces, pooling, batched sorts, the builtin maps and dot_shardmap:
# each on an even shape and on an uneven one, run by every rank and on
# the logical mesh. run_cases(inputs) -> (results, materializations).
_RULE_CASES = r'''
import numpy as np
import torch
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.obs.metrics import collective_totals

# (name, array, tiling): the even ones take the default placement
GRIDS = [("e", "even", None), ("u", "uneven", ("x", None)),
         ("ub", "uneven", ("x", "y")), ("ec", "even", (None, "y"))]


def run_cases(inputs):
    out, mat = {}, {}

    def main(name, fn):
        before = collective_totals()["group_materialize_calls"]
        got = fn()
        if isinstance(got, tuple):
            for i, v in enumerate(got):
                out[f"{name}#{i}"] = np.asarray(v)
        else:
            out[name] = np.asarray(got)
        mat[name] = collective_totals()["group_materialize_calls"] - before

    for g, key, axes in GRIDS:
        a = inputs[key]
        x = st.as_expr(from_numpy(a) if axes is None
                       else from_numpy(a, tiling=Tiling(axes)))
        m, n = a.shape
        main(f"T_{g}", lambda: x.T.glom())
        main(f"Tsum_{g}", lambda: x.T.sum(axis=0).glom())
        main(f"reshape_{g}", lambda: st.reshape(x, (n, m)).glom())
        main(f"reshape3_{g}", lambda: st.reshape(x, (m, 1, n)).glom())
        main(f"ravel_{g}", lambda: st.ravel(x).glom())
        main(f"ravel_max_{g}", lambda: st.ravel(x).max().glom())
        main(f"cat0_{g}", lambda: st.concatenate([x, x * 2.0], 0).glom())
        main(f"cat1_{g}", lambda: st.concatenate([x, x + 1.0], 1).glom())
        main(f"slice_{g}", lambda: x[1:m - 2:2, ::-1].glom())
        main(f"slice_int_{g}", lambda: x[3, 2:].glom())
        main(f"slice_new_{g}", lambda: x[None, ::-3, 1].glom())
        main(f"slice_neg_{g}", lambda: x[-2:2:-2, n - 2:1:-1].glom())
        main(f"slice_sum_{g}", lambda: x[::2, 1::3].sum(axis=1).glom())
        va = st.as_expr(from_numpy(a[:, 0].copy()))
        vb = st.as_expr(from_numpy(a[0].copy()))
        main(f"outer_{g}", lambda: st.outer(va, vb).glom())
        main(f"cumsum_{g}", lambda: st.cumsum(x, 0).glom())
        main(f"cummax_{g}", lambda: st.scan(x, 0, op="max").glom())
        main(f"cumsum_max_{g}", lambda: st.cumsum(x, 0).max(axis=0).glom())
        main(f"ureduce_max_{g}", lambda: st.reduce(
            x, axis=0, local_reduce_fn=lambda b, axis: torch.amax(b, dim=axis),
            accumulate_fn=np.maximum).glom())
        main(f"ureduce_sum_{g}", lambda: st.reduce(
            x, local_reduce_fn=lambda b, axis: torch.sum(b),
            accumulate_fn=np.add).glom())
        main(f"sort0_{g}", lambda: st.sort(x, axis=0).glom())
        main(f"argsort0_{g}", lambda: st.argsort(x, axis=0).glom())
        main(f"sort1_{g}", lambda: st.sort(x, axis=1).glom())
        main(f"argsort1_{g}", lambda: st.argsort(x, axis=1).glom())
        main(f"tril_{g}", lambda: st.tril(x).glom())
        main(f"triu_{g}", lambda: (st.triu(x, 1) + 1.0).glom())
        main(f"diagonal_{g}", lambda: st.diagonal(x).glom())
        main(f"histogram_{g}", lambda: st.histogram(x, 16))
        main(f"histogram_range_{g}", lambda: st.histogram(x, 8, (0.2, 0.7)))
    # batched sorts of rows along their tiled axis, both kernel switches
    bx = st.as_expr(from_numpy(inputs["batch"], tiling=Tiling((None, "x"))))
    for flag in ("on", "off"):
        st.FLAGS.native_kernels = flag
        try:
            main(f"bsort_{flag}", lambda: st.sort(bx).glom())
            main(f"bargsort_{flag}", lambda: st.argsort(bx).glom())
            main(f"bhist_{flag}", lambda: st.histogram(bx, 32))
        finally:
            st.FLAGS.native_kernels = "auto"
    img = st.as_expr(from_numpy(inputs["img"], tiling=Tiling(
        (None, "x", None, None))))
    for name, fn in (("max2", lambda: st.maxpool(img, 2)),
                     ("avg2", lambda: st.avgpool(img, 2)),
                     ("max3s2", lambda: st.maxpool(img, 3, 2, "SAME")),
                     ("avg3s1", lambda: st.avgpool(img, 3, 1, "SAME")),
                     ("max3v", lambda: st.maxpool(img, 3, 1)),
                     ("maxint", lambda: st.maxpool(img.astype(np.int32),
                                                   3, 2, "SAME"))):
        main(f"pool_{name}", lambda: fn().glom())
    A = st.as_expr(from_numpy(inputs["A"]))
    B = st.as_expr(from_numpy(inputs["B"]))
    main("dot_shardmap", lambda: st.dot_shardmap(A, B).glom())
    # no local rule: a user function and a reduce without its combiner
    x = st.as_expr(from_numpy(inputs["even"]))
    before = collective_totals()["group_materialize_calls"]
    out["user_map"] = st.map(lambda v: v.flip(0), x).glom()
    out["user_reduce"] = st.reduce(
        x, axis=0, local_reduce_fn=lambda b, axis: torch.sum(b, axis)).glom()
    out["user_gathers"] = np.array(
        collective_totals()["group_materialize_calls"] - before)
    return out, mat
'''


def _rule_inputs(world: int) -> dict:
    rng = np.random.RandomState(200 + world)
    return {
        "even": rng.rand(12, 8).astype(np.float32),
        "uneven": rng.rand(63, 33).astype(np.float32),
        "batch": rng.randn(6, 1001).astype(np.float32),
        "img": rng.randn(3, 12, 5, 4).astype(np.float32),
        "A": rng.rand(16, 12).astype(np.float32),
        "B": rng.rand(12, 10).astype(np.float32),
    }


_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st

st.set_default_device("cpu")
inputs = dict(np.load(os.environ["INPUTS"]))
assert st.initialize_distributed() is True
mesh = st.get_mesh()
assert mesh.is_group
ns = {}
exec(os.environ["CASES"], ns)
out, mat = ns["run_cases"](inputs)
out["mesh"] = np.array([mesh.shape["x"], mesh.shape["y"], mesh.coords["x"],
                        mesh.coords["y"]])
for name, n in mat.items():
    out["mat_" + name] = np.array(n)
st.shutdown()
np.savez(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.npz"), **out)
print("CHILD_OK", mesh.rank, flush=True)
"""


def _shape(world: int):
    return (2, 1) if world == 2 else (2, 2)


def _inputs(world: int) -> dict:
    rng = np.random.RandomState(100 + world)
    true = (rng.rand(4, 128) * 4.0).astype(np.float32)
    lab = rng.randint(0, 4, 2048)
    n = 512
    nan = np.array([0.0, -0.0, 1.0, np.nan, -np.nan, 1.0, -np.inf, np.nan]
                   * 40, np.float32)
    return {
        "rt": rng.rand(13, 7).astype(np.float32),
        "x": rng.rand(12, 8).astype(np.float32),
        "y": rng.rand(12, 8).astype(np.float32),
        "v": rng.rand(8).astype(np.float32),
        "xi": rng.randint(-9, 10, (12, 8)).astype(np.int32),
        "A": rng.rand(16, 12).astype(np.float32),
        "B": rng.rand(12, 10).astype(np.float32),
        "P": rng.rand(4, 6, 5).astype(np.float32),
        "Q": rng.rand(4, 5, 3).astype(np.float32),
        "R": rng.rand(16, 12).astype(np.float32),
        "upd": rng.rand(8, 7).astype(np.float32),
        "km_pts": (true[lab] + 0.05 * rng.randn(2048, 128)).astype(
            np.float32),
        "km_c0": (true + 0.05 * rng.randn(4, 128)).astype(np.float32),
        "km_labels": lab,
        "keys": rng.rand(1000).astype(np.float32),
        "keys_odd": rng.randn(1001).astype(np.float32),
        "ties": rng.randint(0, 20, 999).astype(np.int32),
        "nan": nan,
        "pr_rows": np.repeat(np.arange(n), 8),
        "pr_cols": rng.randint(0, n, n * 8),
        "pr_n": np.array(n),
        "hist_ids": rng.randint(-4, 70, 10_003).astype(np.int32),
        "seg_vals": rng.randint(-8, 9, (1001, 16)).astype(np.float32),
        "seg_ids": rng.randint(-2, 20, 1001).astype(np.int32),
        "st_img": rng.rand(2, 32, 12, 8).astype(np.float32),
        "st_flt": rng.rand(3, 3, 8, 4).astype(np.float32),
    }


def _launch(world: int, tmp_path, cases: str = _PORT_CASES, inputs=None):
    inputs = _inputs(world) if inputs is None else inputs
    path = tmp_path / "inputs.npz"
    np.savez(path, **inputs)
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, INPUTS=str(path), OUT=str(tmp_path),
                   CASES=cases,
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def join() -> list:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and f"CHILD_OK {rank}" in log, \
                log[-3000:]
        return [dict(np.load(tmp_path / f"rank{r}.npz"))
                for r in range(world)]

    return inputs, join


def _logical(inputs: dict, world: int, cases: str = _PORT_CASES):
    """The same cases on the port's logical mesh of the group's shape."""
    from spartan_tpu_torch.parallel import mesh as mesh_t

    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh(_shape(world), "cpu")):
            ns = {}
            exec(cases, ns)
            return ns["run_cases"](inputs)[0]
    finally:
        mesh_t.set_default_device(prev)


def _jax(inputs: dict, world: int) -> dict:
    """The JAX package's results on the 8-device CPU mesh cut to the
    group's shape."""
    mj = mesh_j.build_mesh(jax.devices()[:world], shape=_shape(world))
    want = {}
    with mesh_j.use_mesh(mj):
        x = st_j.from_numpy(inputs["x"])
        y = st_j.from_numpy(inputs["y"])
        v = st_j.from_numpy(inputs["v"])
        want["map_add"] = (x + y).glom()
        want["map_bcast"] = (x * v + 1.0).glom()
        want["map_exp"] = st_j.exp(x - y).glom()
        for op in ("sum", "max", "argmax", "mean", "min", "argmin"):
            for axis in (None, 0, 1):
                want[f"red_{op}_{axis}"] = getattr(x, op)(axis=axis).glom()
        xi = st_j.from_numpy(inputs["xi"])
        for axis in (None, 0, 1):
            want[f"ired_{axis}"] = xi.sum(axis=axis).glom()
        want["astype_sum"] = (xi.astype(np.float32) * x).sum(axis=0).glom()
        A, B = st_j.from_numpy(inputs["A"]), st_j.from_numpy(inputs["B"])
        want["dot"] = st_j.dot(A, B).glom()
        want["matvec"] = st_j.dot(A, st_j.from_numpy(
            inputs["B"][:, 0])).glom()
        want["einsum"] = st_j.einsum("bij,bjk->bik",
                                     st_j.from_numpy(inputs["P"]),
                                     st_j.from_numpy(inputs["Q"])).glom()
        want["loop"] = st_j.loop(3, lambda c: c * 0.5 + x, x).glom()
        for name in ("keys", "keys_odd", "ties"):
            kx = st_j.from_numpy(inputs[name])
            want[f"sort_{name}"] = st_j.sort(kx).glom()
            want[f"argsort_{name}"] = st_j.argsort(kx).glom()
        FLAGS_J.native_kernels = "off"  # lax.top_k's order (C4)
        try:
            for name, kk in (("ties", 5), ("keys_odd", 6), ("nan", 7)):
                kx = st_j.from_numpy(inputs[name])
                for largest in (True, False):
                    vals, idx = st_j.topk(kx, kk, largest=largest)
                    want[f"topk_{name}_{largest}_v"] = np.asarray(vals.glom())
                    want[f"topk_{name}_{largest}_i"] = np.asarray(idx.glom())
        finally:
            FLAGS_J.native_kernels = "auto"
        FLAGS_J.native_kernels = "on"
        try:
            pts = jnp.asarray(inputs["km_pts"])
            c = jnp.asarray(inputs["km_c0"])
            for _ in range(4):
                c = kk_j.step(pts, c, c.shape[0])
            want["km_loop"] = np.asarray(c)
        finally:
            FLAGS_J.native_kernels = "auto"
        FLAGS_J.native_kernels = "on"
        try:
            xe = st_j.as_expr(inputs["st_img"])
            xe._forced_tiling = tiling_j.Tiling((None, "x", None, None))
            want["stencil"] = np.asarray(st_j.stencil(
                xe, inputs["st_flt"]).glom())
        finally:
            FLAGS_J.native_kernels = "auto"
        n = int(inputs["pr_n"])
        rows = inputs["pr_rows"]
        want["pagerank"] = np.asarray(pagerank_j(SpJ.from_coo(
            rows, inputs["pr_cols"], np.ones(rows.shape[0], np.float32),
            (n, n)), num_iter=20))
        want["map2"] = st_j.map2([x, y], lambda a, b: a * b + b).glom()
        U = st_j.from_numpy(inputs["R"],
                            tiling=tiling_j.Tiling(("x", "y"))).evaluate()
        region = (slice(3, 11), slice(2, 9))
        want["update_add"] = U.update(region, 7.0, "add").glom()
        want["update_set"] = U.update(region, inputs["upd"]).glom()
        want["fetch"] = U.fetch((slice(5, 14), slice(1, 12)))
        want["donate"] = (st_j.as_expr(U) * 2.0).glom()
        ids = inputs["hist_ids"]
        want["bincount"] = st_j.bincount(st_j.from_numpy(ids),
                                         length=64).glom()
        FLAGS_J.native_kernels = "on"
        try:
            sel = reg_j.select("bincount", ids.shape, ids.dtype,
                               tiling_j.row(1), mj, length=64)
            assert sel.pallas
            want["bincount_sharded"] = np.asarray(khist_j.bincount_sharded(
                jnp.asarray(ids), 64, sel, mesh=mj))
            vals = inputs["seg_vals"]
            for kseg in (12, 16):
                sel = reg_j.select("segment_sum", vals.shape, vals.dtype,
                                   tiling_j.row(2), mj, force=True,
                                   num_segments=kseg)
                assert sel.pallas
                want[f"segment_{kseg}"] = np.asarray(
                    kseg_j.segment_sum_sharded(
                        jnp.asarray(vals), jnp.asarray(inputs["seg_ids"]),
                        kseg, sel, mesh=mj))
            want["km_step"] = np.asarray(kk_j.step(
                jnp.asarray(inputs["km_pts"]), jnp.asarray(inputs["km_c0"]),
                inputs["km_c0"].shape[0]))
        finally:
            FLAGS_J.native_kernels = "auto"
    return want


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check(r, want, logical, inputs):
    rt = inputs["rt"]
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.parallel import mesh as mesh_t

    nx, ny, cx, cy = (int(v) for v in r["mesh"])
    lm = mesh_t.Mesh((nx, ny), torch.device("cpu"))
    coords = {"x": cx, "y": cy}
    layouts = {"row": ("x", None), "col": (None, "y"), "block": ("x", "y"),
               "block_t": ("y", "x"), "rep": (None, None),
               "flat": (("x", "y"), None), "row_t": ("y", None)}
    for name, axes in layouts.items():
        ext = Tiling(axes).block_extent(rt.shape, lm, coords)
        np.testing.assert_array_equal(r[f"local_shape_{name}"], ext.shape)
        assert int(r[f"local_bytes_{name}"]) == 4 * ext.size, name
        assert int(r[f"meta_calls_{name}"]) == 0, name
        np.testing.assert_array_equal(r[f"rt_{name}"], rt)
        for d_name, d_axes in layouts.items():
            key = f"retile_{name}_{d_name}"
            np.testing.assert_array_equal(r[key], inputs["R"], key)
            dext = Tiling(d_axes).block_extent(inputs["R"].shape, lm, coords)
            np.testing.assert_array_equal(r[f"retile_shape_{name}_{d_name}"],
                                          dext.shape, key)
        # a move from a split layout to the replicated one receives the
        # other ranks' part of the array
        if name not in ("rep", "col") or ny > 1:
            split = Tiling(axes).block_extent(inputs["R"].shape, lm,
                                              coords).size
            if split < inputs["R"].size:
                assert int(r[f"retile_recv_{name}_rep"]) > 0, name

    # every main-path case gathered nothing whole; a transpose has its
    # local rule (it permutes the rank's block)
    gathered = {key: int(val) for key, val in r.items()
                if key.startswith("mat_") and int(val)}
    assert not gathered
    assert int(r["mat_transpose"]) == 0
    np.testing.assert_array_equal(r["transpose"], inputs["x"].T)
    assert float(r["flop_weight"]) > 0
    # map2 of a * b + b is proven row-partitionable: it runs on the
    # ranks' row blocks (y relaid from its column split), gathering
    # nothing, bit for bit the logical mesh's
    assert int(r["map2_gathers"]) == 0
    assert int(logical["map2_gathers"]) == 0
    np.testing.assert_array_equal(r["map2"], logical["map2"])
    # XLA fuses a * b + b into one rounding; torch rounds twice
    np.testing.assert_allclose(r["map2"], want["map2"], rtol=1e-6)

    # against the JAX package, then the port's logical mesh
    for key in ("map_add", "map_bcast", "smap2"):
        np.testing.assert_array_equal(r[key], logical[key], key)
    np.testing.assert_array_equal(r["map_add"], want["map_add"])
    # XLA fuses x * v + 1 into one rounding; torch rounds twice
    for key in ("map_bcast", "map_exp"):
        np.testing.assert_allclose(r[key], want[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(r["smap2"], inputs["x"] * inputs["v"],
                               rtol=1e-6)
    for op in ("sum", "max", "argmax", "mean", "min", "argmin"):
        for axis in (None, 0, 1):
            key = f"red_{op}_{axis}"
            if op in ("argmax", "argmin", "max", "min"):
                np.testing.assert_array_equal(r[key], want[key], key)
                np.testing.assert_array_equal(r[key], logical[key], key)
            else:
                assert _rel(r[key], want[key]) <= 1e-6, key
                assert _rel(r[key], logical[key]) <= 1e-6, key
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(r[f"ired_{axis}"], want[f"ired_{axis}"])
    assert _rel(r["astype_sum"], want["astype_sum"]) <= 1e-6
    assert _rel(r["astype_sum"], logical["astype_sum"]) <= 1e-6
    ab = inputs["A"] @ inputs["B"]
    for i in range(8):
        assert _rel(r[f"dot_{i}"], want["dot"]) <= 1e-4, i
        assert _rel(r[f"dot_{i}"], ab) <= 1e-4, i
    # plans that split the contraction over an axis of more than one
    # rank all-reduce over it
    for i, (_, k) in enumerate([(None, None)] * 4 + [(None, "x"),
                                                     (None, "y"),
                                                     (None, "y"),
                                                     (None, "x")]):
        if k is not None and {"x": nx, "y": ny}[k] > 1:
            assert int(r[f"dot_calls_{i}"]) > 0, i
    for key in ("dot_noplan", "dot_planned"):
        assert _rel(r[key], want["dot"]) <= 1e-4, key
    assert _rel(r["matvec"], want["matvec"]) <= 1e-4
    assert _rel(r["einsum"], want["einsum"]) <= 1e-4
    for i in range(2):
        assert _rel(r[f"einsum_{i}"], want["einsum"]) <= 1e-4, i
    # the forced k-split over x all-reduces
    assert int(r["einsum_calls_1"]) > 0
    assert _rel(r["loop"], want["loop"]) <= 1e-6
    np.testing.assert_allclose(r["km_loop"], want["km_loop"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r["km_loop"], logical["km_loop"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(r["km_assign"], inputs["km_labels"])
    np.testing.assert_array_equal(r["km_assign"], logical["km_assign"])
    for flag in ("on", "off"):
        for name in ("keys", "keys_odd", "ties"):
            for op in ("sort", "argsort"):
                key = f"{op}_{flag}_{name}"
                np.testing.assert_array_equal(r[key], want[f"{op}_{name}"],
                                              key)
                np.testing.assert_array_equal(r[key], logical[key], key)
    for flag in ("on", "off"):
        for name in ("ties", "keys_odd", "nan"):
            for largest in (True, False):
                key = f"topk_{flag}_{name}_{largest}"
                ref = f"topk_{name}_{largest}"
                np.testing.assert_array_equal(r[key + "_i"], want[ref + "_i"],
                                              key)
                np.testing.assert_array_equal(
                    r[key + "_v"].view(np.uint32 if r[key + "_v"].dtype
                                       == np.float32 else np.int32),
                    want[ref + "_v"].view(np.uint32 if want[ref + "_v"].dtype
                                          == np.float32 else np.int32), key)
                np.testing.assert_array_equal(r[key + "_i"],
                                              logical[key + "_i"], key)
    pr = want["pagerank"]
    assert np.abs(r["pagerank"] - pr).max() <= 1e-6 * pr.max()
    assert np.abs(r["pagerank"] - logical["pagerank"]).max() \
        <= 1e-6 * pr.max()
    R = inputs["R"]
    upd = R.copy()
    upd[3:11, 2:9] += np.float32(7.0)
    np.testing.assert_array_equal(r["update_add"], upd)
    upd = R.copy()
    upd[3:11, 2:9] = inputs["upd"]
    np.testing.assert_array_equal(r["update_set"], upd)
    np.testing.assert_array_equal(r["fetch"], R[5:14, 1:12])
    np.testing.assert_array_equal(r["donate"], R * 2.0)
    for key in ("update_add", "update_set", "fetch", "donate"):
        np.testing.assert_array_equal(r[key], want[key], key)
        np.testing.assert_array_equal(r[key], logical[key], key)
    assert bool(r["donated"]) and bool(r["donated_raises"])
    hist = np.bincount(np.maximum(inputs["hist_ids"], 0), minlength=70)[:64]
    for key in ("bincount", "bincount_sharded", "bincount_tensor"):
        np.testing.assert_array_equal(r[key], hist, key)
        np.testing.assert_array_equal(r[key], logical[key], key)
        np.testing.assert_array_equal(
            r[key], want["bincount" if key == "bincount"
                         else "bincount_sharded"], key)
    for kseg in (12, 16):
        keep = (inputs["seg_ids"] >= 0) & (inputs["seg_ids"] < kseg)
        seg = np.zeros((kseg, 16), np.float32)
        np.add.at(seg, inputs["seg_ids"][keep], inputs["seg_vals"][keep])
        for key in (f"segment_{kseg}", f"segment_tensor_{kseg}"):
            np.testing.assert_array_equal(r[key], seg, key)
            np.testing.assert_array_equal(r[key], want[f"segment_{kseg}"],
                                          key)
            np.testing.assert_array_equal(r[key], logical[key], key)
    np.testing.assert_allclose(r["km_step_tensor"], want["km_step"],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r["km_step_tensor"], logical["km_step_tensor"],
                               rtol=2e-5, atol=1e-6)
    for key in ("stencil", "stencil_tensor"):
        np.testing.assert_allclose(r[key], want["stencil"], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        np.testing.assert_allclose(r[key], logical[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_local_storage_matches_jax_and_the_logical_mesh(world, tmp_path):
    inputs, join = _launch(world, tmp_path)
    want = _jax(inputs, world)  # while the children run
    logical = _logical(inputs, world)
    outs = join()
    for r in outs:
        _check(r, want, logical, inputs)
    # results every rank gathers or computes whole are the same bits
    for other in outs[1:]:
        for key, val in outs[0].items():
            if key == "mesh" or key.startswith(("local_", "retile_shape",
                                                "retile_recv", "mat_",
                                                "meta_")):
                continue
            np.testing.assert_array_equal(other[key], val, err_msg=key)


def _jax_rules(inputs: dict, world: int) -> dict:
    """The JAX package's results of the rule cases on the 8-device CPU
    mesh cut to the group's shape (its own placements: the results do
    not depend on them)."""
    from spartan_tpu.ops.stencil import avgpool, maxpool

    mj = mesh_j.build_mesh(jax.devices()[:world], shape=_shape(world))
    want = {}
    with mesh_j.use_mesh(mj):
        for key in ("even", "uneven"):
            a = inputs[key]
            m, n = a.shape
            x = st_j.from_numpy(a)
            w = want[key] = {}
            w["T"] = x.T.glom()
            w["Tsum"] = x.T.sum(axis=0).glom()
            w["reshape"] = st_j.reshape(x, (n, m)).glom()
            w["reshape3"] = st_j.reshape(x, (m, 1, n)).glom()
            w["ravel"] = st_j.ravel(x).glom()
            w["ravel_max"] = st_j.ravel(x).max().glom()
            w["cat0"] = st_j.concatenate([x, x * 2.0], 0).glom()
            w["cat1"] = st_j.concatenate([x, x + 1.0], 1).glom()
            w["slice"] = x[1:m - 2:2, ::-1].glom()
            w["slice_int"] = x[3, 2:].glom()
            w["slice_new"] = x[None, ::-3, 1].glom()
            w["slice_neg"] = x[-2:2:-2, n - 2:1:-1].glom()
            w["slice_sum"] = x[::2, 1::3].sum(axis=1).glom()
            w["outer"] = st_j.outer(st_j.from_numpy(a[:, 0].copy()),
                                    st_j.from_numpy(a[0].copy())).glom()
            w["cumsum"] = st_j.cumsum(x, 0).glom()
            w["cummax"] = st_j.scan(x, 0, op="max").glom()
            w["cumsum_max"] = st_j.cumsum(x, 0).max(axis=0).glom()
            w["ureduce_max"] = st_j.reduce(
                x, axis=0, local_reduce_fn=lambda b, axis: jnp.max(b, axis),
                accumulate_fn=np.maximum).glom()
            w["ureduce_sum"] = st_j.reduce(
                x, local_reduce_fn=lambda b, axis: jnp.sum(b),
                accumulate_fn=np.add).glom()
            for ax in (0, 1):
                w[f"sort{ax}"] = st_j.sort(x, axis=ax).glom()
                w[f"argsort{ax}"] = st_j.argsort(x, axis=ax).glom()
            w["tril"] = st_j.tril(x).glom()
            w["triu"] = (st_j.triu(x, 1) + 1.0).glom()
            w["diagonal"] = st_j.diagonal(x).glom()
            w["histogram"] = tuple(np.asarray(v.glom()) for v in
                                   st_j.histogram(x, 16))
            w["histogram_range"] = tuple(np.asarray(v.glom()) for v in
                                         st_j.histogram(x, 8, (0.2, 0.7)))
        bx = st_j.from_numpy(inputs["batch"])
        want["bsort"] = st_j.sort(bx).glom()
        want["bargsort"] = st_j.argsort(bx).glom()
        want["bhist"] = tuple(np.asarray(v.glom())
                              for v in st_j.histogram(bx, 32))
        img = st_j.from_numpy(inputs["img"])
        want["pool_max2"] = maxpool(img, 2).glom()
        want["pool_avg2"] = avgpool(img, 2).glom()
        want["pool_max3s2"] = maxpool(img, 3, 2, "SAME").glom()
        want["pool_avg3s1"] = avgpool(img, 3, 1, "SAME").glom()
        want["pool_max3v"] = maxpool(img, 3, 1).glom()
        want["pool_maxint"] = maxpool(img.astype(np.int32), 3, 2,
                                      "SAME").glom()
        want["dot_shardmap"] = st_j.dot_shardmap(
            st_j.from_numpy(inputs["A"]), st_j.from_numpy(inputs["B"])).glom()
    return want


# (case, tolerance against the JAX package): None is bit-equal; a float
# is the relative error allowed (the order of a float sum differs)
_RULE_TOL = {"T": None, "Tsum": 1e-6, "reshape": None, "reshape3": None,
             "ravel": None, "ravel_max": None, "cat0": None, "cat1": None,
             "slice": None, "slice_int": None, "slice_new": None,
             "slice_neg": None, "slice_sum": 1e-6, "outer": None,
             "cumsum": 1e-6, "cummax": None, "cumsum_max": 1e-6,
             "ureduce_max": None, "ureduce_sum": 1e-6, "sort0": None,
             "argsort0": None, "sort1": None, "argsort1": None,
             "tril": None, "triu": None, "diagonal": None}


def _same(got, want, tol, key) -> None:
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        assert _rel(got, want) <= tol, key


def _check_rules(r, want, logical, inputs, world: int) -> None:
    # every case with a rule gathered nothing whole
    gathered = {key: int(val) for key, val in r.items()
                if key.startswith("mat_") and int(val)}
    assert not gathered, gathered
    for g, key in (("e", "even"), ("u", "uneven"), ("ub", "uneven"),
                   ("ec", "even")):
        w = want[key]
        for case, tol in _RULE_TOL.items():
            k = f"{case}_{g}"
            _same(r[k], w[case], tol, k)
            # the logical mesh walks the same program: bit-equal but for
            # float sums, whose order a group changes
            _same(r[k], logical[k], tol, k)
        for case in ("histogram", "histogram_range"):
            for i in range(2):
                k = f"{case}_{g}#{i}"
                np.testing.assert_array_equal(r[k], logical[k], k)
                if i == 0:
                    np.testing.assert_array_equal(r[k], w[case][0], k)
                else:
                    np.testing.assert_allclose(r[k], w[case][1], rtol=1e-6,
                                               err_msg=k)
    for flag in ("on", "off"):
        for case in ("bsort", "bargsort"):
            k = f"{case}_{flag}"
            np.testing.assert_array_equal(r[k], want[case], k)
            np.testing.assert_array_equal(r[k], logical[k], k)
        np.testing.assert_array_equal(r[f"bhist_{flag}#0"], want["bhist"][0])
        np.testing.assert_array_equal(r[f"bhist_{flag}#0"],
                                      logical[f"bhist_{flag}#0"])
    for case in ("max2", "max3s2", "max3v", "maxint"):
        k = f"pool_{case}"
        np.testing.assert_array_equal(r[k], want[k], k)
        np.testing.assert_array_equal(r[k], logical[k], k)
    for case in ("avg2", "avg3s1"):
        k = f"pool_{case}"
        assert _rel(r[k], want[k]) <= 1e-6, k
        assert _rel(r[k], logical[k]) <= 1e-6, k
    assert _rel(r["dot_shardmap"], want["dot_shardmap"]) <= 1e-4
    assert _rel(r["dot_shardmap"], inputs["A"] @ inputs["B"]) <= 1e-4
    # a user function and a reduce without a combiner read their split
    # operand whole: one counted gather each
    assert int(r["user_gathers"]) == 2
    assert int(logical["user_gathers"]) == 0
    np.testing.assert_array_equal(r["user_map"], inputs["even"][::-1])
    assert _rel(r["user_reduce"], inputs["even"].sum(0)) <= 1e-6


@pytest.mark.parametrize("world", [2, 4])
def test_local_rules_match_jax_and_the_logical_mesh(world, tmp_path):
    inputs = _rule_inputs(world)
    _, join = _launch(world, tmp_path, _RULE_CASES, inputs)
    want = _jax_rules(inputs, world)  # while the children run
    logical = _logical(inputs, world, _RULE_CASES)
    outs = join()
    for r in outs:
        _check_rules(r, want, logical, inputs, world)
    # every rank's whole results are the same bits
    for other in outs[1:]:
        for key, val in outs[0].items():
            if key != "mesh" and not key.startswith("mat_"):
                np.testing.assert_array_equal(other[key], val, err_msg=key)


# Creation, random fills, fancy indexing and region writes: the local
# rules that build only a rank's block (each block the same slice of
# the whole array) and move only the rows or region parts a rank takes.
# run_cases(inputs) -> (results, materializations); a case's "_local"
# and "_ext" entries are the rank's block and its extent (ul + lr).
_FILL_CASES = r'''
import numpy as np
import torch
import spartan_tpu_torch as st
from spartan_tpu_torch.array import distarray as da
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.expr.filter import GatherExpr
from spartan_tpu_torch.obs.metrics import collective_totals

TILINGS = {"def": None, "row": ("x", None), "col": (None, "y"),
           "block": ("x", "y"), "flat": (("x", "y"), None),
           "rep": (None, None)}


def run_cases(inputs):
    out, mat = {}, {}

    def main(name, fn):
        before = collective_totals()["group_materialize_calls"]
        r0 = collective_totals()["group_received_bytes"]
        got = fn()
        arr = got if hasattr(got, "local") else got.evaluate()
        mat[name] = collective_totals()["group_materialize_calls"] - before
        out[name + "_recv"] = np.array(
            collective_totals()["group_received_bytes"] - r0)
        out[name] = arr.glom()
        out[name + "_local"] = arr.local.cpu().numpy()
        ext = arr.block_extent()
        out[name + "_ext"] = np.array(ext.ul + ext.lr, np.int64)

    def tiled(axes):
        return None if axes is None else Tiling(axes)

    # creation and random fills under each layout, even and uneven
    for tn, axes in TILINGS.items():
        for shape in ((12, 8), (13, 7)):
            sh = "x".join(map(str, shape))
            main(f"rand_{tn}_{sh}", lambda: st.rand(*shape, seed=5,
                                                    tiling=tiled(axes)))
            main(f"randn_{tn}_{sh}", lambda: st.randn(*shape, seed=6,
                                                      tiling=tiled(axes)))
            main(f"zeros_{tn}_{sh}", lambda: st.zeros(shape,
                                                      tiling=tiled(axes)))
            main(f"full_{tn}_{sh}", lambda: st.full(shape, 2.5,
                                                    tiling=tiled(axes)))
            main(f"eager_rand_{tn}_{sh}", lambda: da.rand(
                *shape, seed=7, tiling=tiled(axes)))
            main(f"eager_randn_{tn}_{sh}", lambda: da.randn(
                *shape, seed=7, tiling=tiled(axes)))
    for name, make in (
            ("randint", lambda: st.randint(10, 9, low=-3, high=40, seed=8,
                                           tile_hint=(5, 9))),
            ("rand3", lambda: st.rand(4, 6, 5, seed=9,
                                      tiling=Tiling((None, "x", "y")))),
            ("randn1", lambda: st.randn(101, seed=10)),
            ("eye", lambda: st.eye(12, 10, 2)),
            ("eye_hint", lambda: st.eye(13, 9, -3, tile_hint=(7, 5))),
            ("eye_int", lambda: st.eye(12, dtype=np.int32)),
            ("arange", lambda: st.arange(5, 200, 3)),
            ("arange_f", lambda: st.arange(0.5, 30.1, 0.7)),
            ("arange_neg", lambda: st.arange(40, -13, -2)),
            ("arange_stop", lambda: st.arange(50.5)),
            ("arange_two", lambda: st.arange(0.1, 40.3)),
            ("arange_f32", lambda: st.arange(3, 70, 2, dtype=np.float32)),
            ("eager_arange", lambda: da.arange(0.5, 30.1, 0.7,
                                               tiling=Tiling(("x",)))),
            ("linspace", lambda: st.linspace(-1.0, 2.0, 101)),
            ("linspace_open", lambda: st.linspace(0.0, 1.0, 100,
                                                  endpoint=False)),
            ("ones_i", lambda: st.ones((14, 4), dtype=np.int32)),
            ("create_sum", lambda: (st.rand(16, 8, seed=11)
                                    + st.arange(8)).sum(axis=0))):
        main(name, make)

    # fancy indexing: duplicates, unsorted, a mask, two index arrays
    xa = inputs["gx"]
    for tn, axes in TILINGS.items():
        x = st.as_expr(from_numpy(xa, tiling=tiled(axes)))
        main(f"gather_{tn}", lambda: x[inputs["gidx"]])
        main(f"gather_dup_{tn}", lambda: x[np.array([2, 2, 2, 11, 2])])
        main(f"gather_mask_{tn}", lambda: x[inputs["gmask"]])
        main(f"gather2_{tn}", lambda: GatherExpr(
            x, (inputs["gi"], inputs["gj"])))
        main(f"gather_map_{tn}", lambda: x[inputs["gidx"]] * 2.0 + 1.0)
    y = st.as_expr(from_numpy(inputs["g3"], tiling=Tiling((None, "x", "y"))))
    main("gather3", lambda: y[inputs["gidx3"]])
    main("gather_empty", lambda: st.as_expr(from_numpy(xa))[
        np.zeros(0, np.int64)])

    # region writes: inside one rank, across ranks, a broadcast source,
    # the reducers; the destination and source under several layouts
    d_np, s_np = inputs["wd"], inputs["ws"]
    for tn, axes in TILINGS.items():
        d = st.as_expr(from_numpy(d_np, tiling=tiled(axes)))
        src = st.as_expr(from_numpy(s_np))
        main(f"assign_in_{tn}", lambda: st.assign(
            d, (slice(1, 4), slice(0, 8)), src[0:3]))
        main(f"assign_across_{tn}", lambda: st.assign(d, (
            slice(4, 10), slice(2, 8)), from_numpy(s_np[:, 2:].copy())))
        main(f"assign_bcast_{tn}", lambda: st.assign(
            d, (slice(3, 11), slice(0, 8)), from_numpy(s_np[1].copy())))
        main(f"assign_scalar_{tn}", lambda: st.assign(
            d, (slice(2, 9), slice(1, 6)), 7.5))
        main(f"assign_add_{tn}", lambda: st.assign(
            d, (slice(0, 6), slice(0, 8)), src, "add"))
        main(f"assign_max_{tn}", lambda: st.assign(
            d, (slice(5, 11), slice(0, 8)),
            from_numpy(s_np, tiling=Tiling((None, "y"))), "max"))
        main(f"write_array_{tn}", lambda: st.write_array(
            (12, 8), (slice(6, 12), slice(0, 8)), src, tile_hint=(6, 4)))
        U = from_numpy(d_np, tiling=tiled(axes))
        main(f"update_across_{tn}", lambda: U.update(
            (slice(3, 9), slice(0, 8)), from_numpy(s_np)))
        main(f"update_in_{tn}", lambda: U.update(
            (slice(0, 2), slice(1, 5)), from_numpy(s_np[:2, :4].copy()),
            "add"))
        main(f"update_bcast_{tn}", lambda: U.update(
            (slice(2, 12), slice(0, 8)), from_numpy(s_np[4].copy(),
                                                    tiling=Tiling(("x",))),
            "max"))
        main(f"update_int_{tn}", lambda: U.update(
            (slice(1, 7), slice(0, 8)), from_numpy(
                inputs["wi"], tiling=Tiling((None, "x")))))

    # the card model of a DistArray update: a column-tiled value into
    # row-tiled rows 3..9 (``test_update_card_bytes_on_two_ranks``)
    Ur = from_numpy(d_np, tiling=Tiling(("x", None)))
    vc = from_numpy(s_np, tiling=Tiling((None, "x")))
    reg = (slice(3, 9), slice(0, 8))
    out["card_update"] = np.array([
        Ur.update_card_bytes(reg, vc), Ur.update_card_bytes(reg, vc, "add"),
        Ur.update_card_bytes(reg, from_numpy(inputs["wi"], tiling=Tiling(
            (None, "x"))))])

    # a sliding window fed DistArray batches (the third one wraps)
    from spartan_tpu_torch.examples import streaming

    def window():
        sw = streaming.SlidingWindowStats(16, 8)
        for batch in inputs["sw"]:
            sw.push(from_numpy(batch))
        sw.push(from_numpy(inputs["sw"][0, 0]))  # one row
        return sw.buf

    main("sw_buf", window)
    return out, mat
'''


def _fill_inputs(world: int) -> dict:
    rng = np.random.RandomState(300 + world)
    gx = rng.rand(13, 7).astype(np.float32)
    return {
        "gx": gx,
        "gidx": np.array([12, 0, 5, 5, 3, 12, 1, 9, 6]),
        "gmask": gx > 0.6,
        "gi": rng.randint(0, 13, (3, 4)),
        "gj": rng.randint(0, 7, (3, 4)),
        "g3": rng.rand(9, 6, 5).astype(np.float32),
        "gidx3": np.array([8, 0, 4, 4, 7, 1]),
        "wd": rng.rand(12, 8).astype(np.float32),
        "ws": rng.rand(6, 8).astype(np.float32),
        "wi": rng.randint(-5, 5, (6, 8)).astype(np.int32),
        "sw": rng.rand(4, 6, 8).astype(np.float32),
    }


def _jax_fills(inputs: dict, world: int) -> dict:
    """The JAX package's fancy indexing and region writes on the
    8-device CPU mesh cut to the group's shape (its own placements: the
    results do not depend on them)."""
    from spartan_tpu.expr.filter import GatherExpr as GatherJ

    from spartan_tpu.array import distarray as da_j

    mj = mesh_j.build_mesh(jax.devices()[:world], shape=_shape(world))
    want = {}
    with mesh_j.use_mesh(mj):
        for shape in ((12, 8), (13, 7)):
            sh = "x".join(map(str, shape))
            for tn in ("def", "row", "col", "block", "flat", "rep"):
                want[f"zeros_{tn}_{sh}"] = st_j.zeros(shape).glom()
                want[f"full_{tn}_{sh}"] = st_j.full(shape, 2.5).glom()
        for name, make in (
                ("eye", lambda: st_j.eye(12, 10, 2)),
                ("eye_hint", lambda: st_j.eye(13, 9, -3, tile_hint=(7, 5))),
                ("eye_int", lambda: st_j.eye(12, dtype=np.int32)),
                ("arange", lambda: st_j.arange(5, 200, 3)),
                ("arange_f", lambda: st_j.arange(0.5, 30.1, 0.7)),
                ("arange_neg", lambda: st_j.arange(40, -13, -2)),
                ("arange_stop", lambda: st_j.arange(50.5)),
                ("arange_two", lambda: st_j.arange(0.1, 40.3)),
                ("arange_f32", lambda: st_j.arange(3, 70, 2,
                                                   dtype=np.float32)),
                ("linspace", lambda: st_j.linspace(-1.0, 2.0, 101)),
                ("linspace_open", lambda: st_j.linspace(0.0, 1.0, 100,
                                                        endpoint=False)),
                ("ones_i", lambda: st_j.ones((14, 4), dtype=np.int32))):
            want[name] = make().glom()
        want["eager_arange"] = da_j.arange(0.5, 30.1, 0.7).glom()
        x = st_j.from_numpy(inputs["gx"])
        want["gather"] = x[inputs["gidx"]].glom()
        want["gather_dup"] = x[np.array([2, 2, 2, 11, 2])].glom()
        want["gather_mask"] = x[inputs["gmask"]].glom()
        want["gather2"] = GatherJ(x, (inputs["gi"], inputs["gj"])).glom()
        want["gather_map"] = (x[inputs["gidx"]] * 2.0 + 1.0).glom()
        want["gather3"] = st_j.from_numpy(inputs["g3"])[
            inputs["gidx3"]].glom()
        d, s_np = st_j.from_numpy(inputs["wd"]), inputs["ws"]
        src = st_j.from_numpy(s_np)
        want["assign_in"] = st_j.assign(d, (slice(1, 4), slice(0, 8)),
                                        src[0:3]).glom()
        want["assign_across"] = st_j.assign(
            d, (slice(4, 10), slice(2, 8)), s_np[:, 2:].copy()).glom()
        want["assign_bcast"] = st_j.assign(
            d, (slice(3, 11), slice(0, 8)), s_np[1].copy()).glom()
        want["assign_scalar"] = st_j.assign(d, (slice(2, 9), slice(1, 6)),
                                            7.5).glom()
        want["assign_add"] = st_j.assign(d, (slice(0, 6), slice(0, 8)), src,
                                         "add").glom()
        want["assign_max"] = st_j.assign(d, (slice(5, 11), slice(0, 8)),
                                         src, "max").glom()
        want["write_array"] = st_j.write_array(
            (12, 8), (slice(6, 12), slice(0, 8)), src).glom()
        U = st_j.from_numpy(inputs["wd"]).evaluate()
        want["update_across"] = U.update((slice(3, 9), slice(0, 8)),
                                         s_np).glom()
        want["update_in"] = U.update((slice(0, 2), slice(1, 5)),
                                     s_np[:2, :4], "add").glom()
        want["update_bcast"] = U.update((slice(2, 12), slice(0, 8)),
                                        s_np[4], "max").glom()
        want["update_int"] = U.update((slice(1, 7), slice(0, 8)),
                                      inputs["wi"]).glom()
        from spartan_tpu.examples import streaming as streaming_j

        sw = streaming_j.SlidingWindowStats(16, 8)
        for batch in inputs["sw"]:
            sw.push(batch)
        sw.push(inputs["sw"][0, 0])
        want["sw_buf"] = sw.buf.glom()
    return want


def _check_fills(r, want, logical) -> None:
    for key in r:
        if key.endswith(("_local", "_ext", "_recv")) or key == "mesh" \
                or key.startswith(("mat_", "card_")):
            continue
        # nothing read whole; the whole result and the rank's block are
        # the logical mesh's bits (a sum along a split axis adds per-rank
        # partials on a group: 1e-6)
        assert int(r[f"mat_{key}"]) == 0, key
        if key == "create_sum":
            assert _rel(r[key], logical[key]) <= 1e-6
            continue
        np.testing.assert_array_equal(r[key], logical[key], err_msg=key)
        ext = r[key + "_ext"]
        nd = ext.size // 2
        sl = tuple(slice(int(a), int(b)) for a, b in zip(ext[:nd], ext[nd:]))
        np.testing.assert_array_equal(r[key + "_local"], logical[key][sl],
                                      err_msg=key)
        base = key.rsplit("_", 1)[0] if key.rsplit("_", 1)[-1] in (
            "def", "row", "col", "block", "flat", "rep") else key
        if base in want:
            np.testing.assert_array_equal(r[key], want[base], err_msg=key)
            assert r[key].dtype == want[base].dtype, key


@pytest.mark.parametrize("world", [2, 4])
def test_fills_gathers_writes_match_jax_and_the_logical_mesh(world,
                                                             tmp_path):
    inputs = _fill_inputs(world)
    _, join = _launch(world, tmp_path, _FILL_CASES, inputs)
    want = _jax_fills(inputs, world)  # while the children run
    logical = _logical(inputs, world, _FILL_CASES)
    outs = join()
    for r in outs:
        _check_fills(r, want, logical)
    # a rank whose block misses a region write receives nothing, and a
    # write whose source each rank holds where it writes moves nothing
    if world == 2:
        assert int(outs[1]["assign_in_row_recv"]) == 0
        assert int(outs[0]["assign_in_row_recv"]) > 0  # src is col-tiled
        assert int(outs[1]["update_in_row_recv"]) == 0
    for r in outs:
        assert int(r["assign_scalar_row_recv"]) == 0
        assert int(r["rand_block_12x8_recv"]) == 0
    if world == 2:
        # each rank: its 3 x 8 part of the value (96 bytes) beside the
        # exchange's 12 elements each way (96), then beside its 6 x 8
        # block (192); an add's result over the part (96) and an int
        # value's cast (96) come on top of the block
        for r in outs:
            assert r["card_update"].tolist() == [288.0, 384.0, 384.0]


_DRAWS = {"uniform": (np.float32, (0, 0)), "normal": (np.float32, (0, 0)),
          "randint": (np.int32, (-7, 1000))}


@pytest.mark.parametrize("kind", sorted(_DRAWS))
@pytest.mark.parametrize("mesh", [(1, 1), (4, 2), (8, 1), (2, 4)])
def test_random_draw_blocks_are_slices_of_the_whole_draw(mesh, kind):
    """Any block of a counter-based draw, on any mesh position of the
    four logical meshes and under any tiling, and any box cut from it,
    is the same slice of the whole draw; the lazy and the eager draws
    are the same bits. (The group's ranks: the fills test above.)"""
    from spartan_tpu_torch.array import distarray as da_t
    from spartan_tpu_torch.array.extent import TileExtent
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.expr.ndarray import RandomExpr
    from spartan_tpu_torch.parallel import mesh as mesh_t
    from spartan_tpu_torch.parallel import redistribute as redist_t
    from spartan_tpu_torch.utils import philox

    dtype, rng_ = _DRAWS[kind]
    shape = (37, 29, 6)
    whole = philox.draw(kind, 12345, shape, philox.whole(shape),
                        torch.from_numpy(np.zeros(0, dtype)).dtype, "cpu",
                        rng_).numpy()
    rng = np.random.RandomState(len(kind))
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh(mesh, "cpu")):
            m = mesh_t.get_mesh()
            for axes in ((None, None, None), ("x", None, None),
                         (None, "y", "x"), ("x", "y", None),
                         (("x", "y"), None, None)):
                e = RandomExpr(shape, kind, 12345, dtype, Tiling(axes))
                e.params_range = rng_
                np.testing.assert_array_equal(e.glom(), whole)
                for c in redist_t._coords(m):
                    ext = Tiling(axes).block_extent(shape, m, c)
                    np.testing.assert_array_equal(
                        e.block(ext, torch.device("cpu")).numpy(),
                        whole[ext.to_slice()])
            for _ in range(20):
                ul = [int(rng.randint(0, d)) for d in shape]
                lr = [int(rng.randint(u, d + 1)) for u, d in zip(ul, shape)]
                ext = TileExtent(ul, lr, shape)
                np.testing.assert_array_equal(
                    e.block(ext, torch.device("cpu")).numpy(),
                    whole[ext.to_slice()])
            if kind != "randint":
                eager = (da_t.rand if kind == "uniform" else da_t.randn)(
                    *shape, seed=12345, tiling=Tiling(("x", None, None)))
                np.testing.assert_array_equal(eager.glom(), whole)
    finally:
        mesh_t.set_default_device(prev)


_ARANGES = [(5, 200, 3), (0.5, 30.1, 0.7), (40, -13, -2), (0.1, 50.3, 0.13),
            (-3.7, 100.0, 0.31), (1000.0, 2850.0, 0.37), (0, 1, 1e-4),
            (50.5,), (7,), (0.1, 40.3), (-5, 20), (3, 70.5), (9, 2, 1),
            (np.float32(1.5), 9, np.float32(0.25))]


@pytest.mark.parametrize("args", _ARANGES, ids=str)
@pytest.mark.parametrize("dtype", [None, np.float32, np.int32])
def test_arange_length_dtype_and_blocks_match_numpy_and_jax(args, dtype):
    """``st.arange`` learns its length and dtype from its arguments
    without making the array (numpy's, canonicalized as the JAX
    package's), and every block of its fill is the same slice of the
    JAX package's ``jnp.arange``: a stepped float fill in float32, not
    a float64 fill cast down."""
    from spartan_tpu_torch.expr import builtins as bt
    from spartan_tpu_torch.expr.ndarray import _arange_block
    from spartan_tpu_torch.utils import dtypes as dtypes_t

    e, ej = bt.arange(*args, dtype=dtype), st_j.arange(*args, dtype=dtype)
    assert e.shape == ej.shape == np.arange(*args, dtype=dtype).shape
    assert np.dtype(e.dtype) == np.dtype(ej.dtype)
    want = np.asarray(jnp.arange(*args, dtype=ej.dtype))
    n, dt = e.shape[0], dtypes_t.to_torch(e.dtype)
    for lo, hi in ((0, n), (0, 1), (1, 2), (1, n), (2, n // 2 + 1),
                   (n // 3, n)):
        if lo < hi <= n:
            got = _arange_block(args, lo, hi, dt, "cpu").numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want[lo:hi])


# User functions on a group: map2 steps proven row-partitionable (a
# partial sum all-reduced once), row-local predict kernels and proven
# elementwise maps on each rank's blocks (a size read from a shape keeps
# its whole value), ALS's batched solve, the trace and a mean over the
# rows (one all-reduce each), a flip (a move of the mirrored rows) and
# the masked median along either axis (the operands moved so that the
# axis is whole where it is split). run_cases(inputs) -> (results,
# materializations); "reduces_<case>" counts the case's all-reduces.
_PART_CASES = r"""
import numpy as np
import torch
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.array import masked
from spartan_tpu_torch.examples import als, fuzzy_kmeans, naive_bayes
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.examples import regression, svm
from spartan_tpu_torch.obs.metrics import REGISTRY, collective_totals

REDUCES = 'collective_calls{op="all_reduce"}'


def run_cases(inputs):
    out, mat = {}, {}

    def main(name, fn):
        m0 = collective_totals()["group_materialize_calls"]
        r0 = REGISTRY.counter_values().get(REDUCES, 0)
        out[name] = np.asarray(fn())
        mat[name] = collective_totals()["group_materialize_calls"] - m0
        out["reduces_" + name] = np.array(
            REGISTRY.counter_values().get(REDUCES, 0) - r0)

    x = st.as_expr(from_numpy(inputs["X"]))
    y01 = st.as_expr(from_numpy(inputs["y01"]))
    ylin = st.as_expr(from_numpy(inputs["ylin"]))
    ypm = st.as_expr(from_numpy(inputs["ypm"]))
    w = st.as_expr(from_numpy(inputs["w"], tiling=Tiling((None,))))
    main("logistic_grad",
         lambda: regression.logistic_grad(x, y01, w).glom())
    main("linear_grad", lambda: regression.linear_grad(x, ylin, w).glom())
    main("svm_grad", lambda: svm.svm_grad(x, ypm, w, 1e-3).glom())
    main("logreg", lambda: regression.logistic_regression(x, y01,
                                                          num_iter=3))
    p = st.as_expr(from_numpy(inputs["pts"]))
    c = st.as_expr(from_numpy(inputs["c0"]))
    k = inputs["c0"].shape[0]
    main("fuzzy_kmeans_step",
         lambda: fuzzy_kmeans.fuzzy_kmeans_step(p, c, k).glom())
    st.FLAGS.native_kernels = "off"  # kmeans_step's map2 form
    try:
        main("kmeans_step_map2", lambda: km.kmeans_step(p, c, k).glom())
    finally:
        st.FLAGS.native_kernels = "auto"
    main("predict_logistic",
         lambda: regression.predict_logistic(x, w).glom())
    main("predict_svm", lambda: svm.predict(x, w).glom())
    main("predict_nb", lambda: naive_bayes.predict(
        x, inputs["nb_prior"], inputs["nb_lik"]).glom())
    x2 = st.as_expr(from_numpy(inputs["X2"]))
    main("map_where", lambda: st.map(
        lambda a, b: torch.where(a > b, a - b, 0.5 * b), x, x2).glom())
    main("map_bcast", lambda: st.map(lambda a, b: a * b + 1.0, x,
                                     w).glom())
    # the program traced at the whole shape: its constant is the whole
    # row count on every block
    main("map_shape", lambda: st.map(lambda a: a / a.shape[0], x).glom())
    # each rank's mirrored rows moved to it
    main("map2_flip", lambda: st.map2([x], lambda a: a.flip(0)).glom())
    # a mean over the rows: the blocks' sums all-reduced, then divided
    main("mean_center", lambda: st.map2([x], lambda a: a - a.mean(0)).glom())
    sq = st.as_expr(from_numpy(inputs["sq"]))
    main("trace", lambda: np.asarray(st.trace(sq).glom()))
    sqi = st.as_expr(from_numpy(inputs["sqi"]))
    main("trace_int", lambda: np.asarray(st.trace(sqi, -3).glom()))
    # ALS's half-step on each rank's users, and two iterations (the
    # transposed ratings laid out by their own rows once)
    r = st.as_expr(from_numpy(inputs["ratings"]))
    v = st.as_expr(from_numpy(inputs["factor"], tiling=Tiling((None, None))))
    main("als_half", lambda: st.map2([r, v], als._solve_side,
                                     fn_kw={"reg": 0.1},
                                     out_tiling=Tiling(("x", None))).glom())
    main("als", lambda: np.concatenate(
        [f.ravel() for f in als.als(r, k=4, num_iter=2, reg=0.1)]))
    rows = Tiling(("x", None))
    mx = masked.MaskedDistArray(from_numpy(inputs["md"], tiling=rows),
                                from_numpy(inputs["mm"], tiling=rows))
    main("masked_median_ax1", lambda: st.median(mx, axis=1).glom())
    main("masked_median_ax0", lambda: st.median(mx, axis=0).glom())
    # proven: the segment sums' partials over each rank's rows
    cnt = st.as_expr(from_numpy(inputs["nb_x"]))
    lab = st.as_expr(from_numpy(inputs["nb_y"]))
    main("nb_fit", lambda: np.concatenate(
        [v.ravel() for v in naive_bayes.fit(cnt, lab, k)]))
    return out, mat
"""


def _part_inputs(world: int) -> dict:
    rng = np.random.RandomState(300 + world)
    n, d, k = 4096, 16, 4
    x = rng.rand(n, d).astype(np.float32)
    w_true = rng.randn(d).astype(np.float32)
    y01 = ((x - 0.5) @ w_true > 0).astype(np.float32)
    true = (rng.rand(k, 32) * 4.0).astype(np.float32)
    lab = rng.randint(0, k, n)
    return {
        "X": x, "X2": rng.rand(n, d).astype(np.float32),
        "y01": y01, "ylin": (x @ w_true).astype(np.float32),
        "ypm": (2.0 * y01 - 1.0).astype(np.float32),
        "w": (0.1 * rng.randn(d)).astype(np.float32),
        "pts": (true[lab] + 0.05 * rng.randn(n, 32)).astype(np.float32),
        "c0": (true + 0.05 * rng.randn(k, 32)).astype(np.float32),
        "nb_prior": rng.randn(k).astype(np.float32),
        "nb_lik": rng.randn(k, d).astype(np.float32),
        "nb_x": rng.randint(0, 5, (n, 8)).astype(np.float32),
        "nb_y": lab.astype(np.int32),
        "sq": rng.rand(256, 256).astype(np.float32),
        "sqi": rng.randint(-1000, 1000, (256, 256)).astype(np.int32),
        "ratings": (np.floor(rng.rand(n, 48) * 5.0 + 1.0)
                    * (rng.rand(n, 48) > 0.4)).astype(np.float32),
        "factor": (0.1 * rng.rand(48, 4)).astype(np.float32),
        "md": np.where(rng.rand(8, 2048) < 0.01, np.nan,
                       rng.randn(8, 2048)).astype(np.float32),
        "mm": rng.rand(8, 2048) < 0.05,
    }


def _jax_parts(inputs: dict, world: int) -> dict:
    """The JAX package's same functions on the 8-device CPU mesh cut to
    the group's shape."""
    from spartan_tpu.array import masked as masked_j
    from spartan_tpu.examples import als as als_j
    from spartan_tpu.examples import fuzzy_kmeans as fz_j
    from spartan_tpu.examples import kmeans as km_j
    from spartan_tpu.examples import naive_bayes as nb_j
    from spartan_tpu.examples import regression as reg_j
    from spartan_tpu.examples import svm as svm_j

    mj = mesh_j.build_mesh(jax.devices()[:world], shape=_shape(world))
    want = {}
    with mesh_j.use_mesh(mj):
        x = st_j.from_numpy(inputs["X"])
        w = st_j.from_numpy(inputs["w"], tiling=tiling_j.Tiling((None,)))
        y01 = st_j.from_numpy(inputs["y01"])
        want["logistic_grad"] = reg_j.logistic_grad(x, y01, w).glom()
        want["linear_grad"] = reg_j.linear_grad(
            x, st_j.from_numpy(inputs["ylin"]), w).glom()
        want["svm_grad"] = svm_j.svm_grad(
            x, st_j.from_numpy(inputs["ypm"]), w, 1e-3).glom()
        want["logreg"] = reg_j.logistic_regression(x, y01, num_iter=3)
        p, c = st_j.from_numpy(inputs["pts"]), st_j.from_numpy(inputs["c0"])
        k = inputs["c0"].shape[0]
        want["fuzzy_kmeans_step"] = fz_j.fuzzy_kmeans_step(p, c, k).glom()
        want["kmeans_step_map2"] = km_j.kmeans_step(p, c, k).glom()
        want["predict_logistic"] = reg_j.predict_logistic(x, w).glom()
        want["predict_svm"] = svm_j.predict(x, w).glom()
        want["predict_nb"] = nb_j.predict(x, inputs["nb_prior"],
                                          inputs["nb_lik"]).glom()
        x2 = st_j.from_numpy(inputs["X2"])
        want["map_where"] = st_j.map(
            lambda a, b: jnp.where(a > b, a - b, 0.5 * b), x, x2).glom()
        want["map_bcast"] = st_j.map(lambda a, b: a * b + 1.0, x, w).glom()
        want["map_shape"] = st_j.map(lambda a: a / a.shape[0], x).glom()
        want["map2_flip"] = st_j.map2([x], lambda a: jnp.flip(a, 0)).glom()
        want["mean_center"] = st_j.map2([x], lambda a: a - a.mean(0)).glom()
        want["trace"] = np.asarray(st_j.trace(
            st_j.from_numpy(inputs["sq"])).glom())
        want["trace_int"] = np.asarray(st_j.trace(
            st_j.from_numpy(inputs["sqi"]), -3).glom())
        r = st_j.from_numpy(inputs["ratings"])
        want["als_half"] = st_j.map2(
            [r, st_j.from_numpy(inputs["factor"],
                                tiling=tiling_j.Tiling((None, None)))],
            lambda rv, vv: als_j._solve_side(rv, vv, 0.1),
            out_tiling=tiling_j.Tiling(("x", None))).glom()
        want["als"] = np.concatenate(
            [f.ravel() for f in als_j.als(r, k=4, num_iter=2, reg=0.1)])
        rows = tiling_j.Tiling(("x", None))
        mx = masked_j.MaskedDistArray(
            st_j.from_numpy(inputs["md"], tiling=rows),
            st_j.from_numpy(inputs["mm"], tiling=rows))
        want["masked_median_ax1"] = st_j.median(mx, axis=1).glom()
        want["masked_median_ax0"] = st_j.median(mx, axis=0).glom()
        want["nb_fit"] = np.concatenate([v.ravel() for v in nb_j.fit(
            st_j.from_numpy(inputs["nb_x"]), st_j.from_numpy(inputs["nb_y"]),
            k)])
    return want


# case: (tolerance against the logical mesh, against the JAX package, the
# all-reduces a proven case makes; None for an unproven one). 0 is
# bit-equal: an elementwise or row-local result, on blocks of whole
# multiples of 64 rows (the host BLAS's row groups), a move of rows, an
# integer sum or a median; a partial sum's order changes on a group
# (1e-5), a mean over the rows divides the all-reduced sum (1e-6 of the
# logical mesh). Against the JAX package XLA fuses and rounds its own
# way (its sigmoid; a * b + 1 in one FMA; its batched LU solve).
_PART_TOL = {
    "logistic_grad": (1e-5, 1e-5, 1), "linear_grad": (1e-5, 1e-5, 1),
    "svm_grad": (1e-5, 1e-5, 1), "logreg": (1e-5, 1e-5, 3),
    "fuzzy_kmeans_step": (1e-5, 1e-5, 1),
    "kmeans_step_map2": (1e-5, 1e-5, 1),
    "predict_logistic": (0, 1e-6, 0), "predict_svm": (0, 0, 0),
    "predict_nb": (0, 0, 0), "map_where": (0, 0, 0),
    "map_bcast": (0, 1e-6, 0),
    "map_shape": (0, 1e-6, 0), "map2_flip": (0, 0, 0),
    "mean_center": (1e-6, 1e-5, 1), "trace": (1e-6, 1e-5, 1),
    "trace_int": (0, 0, 1), "als_half": (0, 1e-4, 0), "als": (0, 1e-4, 0),
    "masked_median_ax1": (0, 0, 0), "masked_median_ax0": (0, 0, 0),
    # naive Bayes's fit: one all-reduce of the (k, d + 1) partial
    # counts; integer counts sum exactly, so its tables are the JAX
    # package's bits
    "nb_fit": (0, 0, 1),
}


def _check_parts(r, want, logical) -> None:
    for case, (tol_l, tol_j, reduces) in _PART_TOL.items():
        got = r[case]
        for ref, tol, what in ((logical[case], tol_l, "logical"),
                               (want[case], tol_j, "jax")):
            if tol == 0:
                np.testing.assert_array_equal(got, ref,
                                              err_msg=f"{case} {what}")
            else:
                assert _rel(got, ref) <= tol, (case, what, _rel(got, ref))
            assert np.asarray(got).dtype == np.asarray(ref).dtype, (case,
                                                                     what)
        if reduces is None:
            # unproven: its split operands read whole, counted
            assert int(r[f"mat_{case}"]) >= 1, case
            assert int(logical[f"reduces_{case}"]) == 0, case
        else:
            assert int(r[f"mat_{case}"]) == 0, case
            assert int(r[f"reduces_{case}"]) == reduces, case


@pytest.mark.parametrize("world", [2, 4])
def test_user_functions_keep_blocks_on_a_group(world, tmp_path):
    inputs = _part_inputs(world)
    _, join = _launch(world, tmp_path, _PART_CASES, inputs)
    want = _jax_parts(inputs, world)  # while the children run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the children's BLAS runs on one thread
    try:
        logical = _logical(inputs, world, _PART_CASES)
    finally:
        torch.set_num_threads(threads)
    outs = join()
    for r in outs:
        _check_parts(r, want, logical)
    for other in outs[1:]:
        for key, val in outs[0].items():
            if key != "mesh" and not key.startswith("mat_"):
                np.testing.assert_array_equal(other[key], val, err_msg=key)


# The port's Expr subclasses without a local rule (ROADMAP §A): leaves
# and carries the walk seeds (never lowered) and the dict wrapper
# (walked through its tuple). The incremental engine's
# restriction nodes (made when the engine first runs; the test makes
# them first, so the list does not depend on the tests before it) have
# their rules. The list may only shrink.
_NO_LOCAL_RULE = {
    "spartan_tpu_torch.expr.base.DictExpr",
    "spartan_tpu_torch.expr.base.ScalarExpr",
    "spartan_tpu_torch.expr.base.ValExpr",
    "spartan_tpu_torch.expr.loop.CarryExpr",
    "spartan_tpu_torch.expr.loop.LoopIndexExpr",
}


def test_exprs_without_a_local_rule_are_the_listed_ones():
    import importlib
    import pkgutil

    import spartan_tpu_torch
    from spartan_tpu_torch.expr.base import Expr

    for mod in pkgutil.walk_packages(spartan_tpu_torch.__path__,
                                     "spartan_tpu_torch."):
        importlib.import_module(mod.name)
    from spartan_tpu_torch.expr import incremental

    incremental._types()
    seen, todo = set(), [Expr]
    while todo:
        for sub in todo.pop().__subclasses__():
            if sub not in seen:
                seen.add(sub)
                todo.append(sub)
    missing = {f"{c.__module__}.{c.__name__}" for c in seen
               if c._lower_local is None}
    assert missing == _NO_LOCAL_RULE
