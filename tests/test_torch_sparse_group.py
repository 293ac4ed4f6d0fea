"""Sparse arrays, segment sums and masked sorts on a group mesh: each rank
keeps its entries.

Gloo groups of 2 and 4 CPU processes (meshes 2x1 and 2x2), launched as
tests/test_torch_local_storage.py launches them: a ``file://`` store
under ``tmp_path``, children that import torch and the port only, and
one code string of cases (``_CASES``) run by every rank and, in the
parent, on the port's logical mesh of the group's shape. The JAX
package's ``SparseDistArray`` runs on its 8-device CPU mesh cut to the
group's shape while the children do.

Held bit for bit against the JAX package and the logical mesh:
``from_coo``, ``from_coo_device`` (on values in multiples of 1/8, which
every order of additions sums exactly, beside a coordinate repeated
100,000 times whose run straddles the ranks' block boundary),
``transpose``, ``scale_rows``, ``transition``, ``todense`` and the
glommed entry arrays. On random values the group dedup is held bit for
bit against the one-process dedup (its pairwise tree sums each run in
the same order). Checkpoints cross meshes: saved on the group and
loaded in one process, and the other way round, bit for bit. Within a
stated tolerance: ``rsums`` and every ``spmv`` path (1e-6 of the
largest: a row's partials merge in rank order) and PageRank (1e-6 of the
largest rank). Each rank stores nse / nx entries (asserted in bytes);
no case gathers (``group_materialize_calls``) except an SpMV of a split
``DistArray`` operand (``spmv``, the JAX package replicates it too) and
``matrix_fact``'s entry stream (``matrix_fact_stream``). Masked sorts and
argsorts of rows run on each rank's rows, bit-equal, gathering nothing.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spartan_tpu.array.sparse import SparseDistArray as SpJ
from spartan_tpu.examples.pagerank import pagerank as pagerank_j
from spartan_tpu.parallel import mesh as mesh_j

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240

_CASES = r'''
import os
import numpy as np
import torch
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.masked import MaskedDistArray, masked_argsort
from spartan_tpu_torch.array.masked import masked_sort
from spartan_tpu_torch.array.sparse import SparseDistArray as Sp
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.examples import matrix_fact
from spartan_tpu_torch.examples.pagerank import pagerank
from spartan_tpu_torch.obs.metrics import materialize_sites
from spartan_tpu_torch.utils import checkpoint as ckpt


def run_cases(inputs, workdir):
    out, mat = {}, {}
    mesh = st.get_mesh()

    def main(name, fn):
        before = materialize_sites()
        out[name] = np.asarray(fn())
        after = materialize_sites()
        mat[name] = {s: after[s] - before.get(s, 0) for s in after
                     if after[s] != before.get(s, 0)}
        return out[name]

    def entries(name, sp):
        # the glommed entry arrays (a counted gather of its own, outside
        # the cases) and the bytes this rank stores
        d, r, c = sp.whole_entries("test_glom")
        out[name + "_data"], out[name + "_rows"] = d.numpy(), r.numpy()
        out[name + "_cols"] = c.numpy()
        out[name + "_meta"] = np.array([sp.nse, sp.nnz])
        blk = sp.block
        out[name + "_bytes"] = np.array(sum(
            t.numel() * t.element_size() for t in blk[:3]))

    n, m = (int(v) for v in inputs["shape"])
    A = {}
    main("coo", lambda: A.setdefault("a", Sp.from_coo(
        inputs["rows"], inputs["cols"], inputs["vals"], (n, m))).nnz)
    a = A["a"]
    entries("coo", a)
    dn, dm = (int(v) for v in inputs["dshape"])
    for name in ("exact", "noisy"):
        got = {}
        main(f"dev_{name}", lambda: got.setdefault("s", Sp.from_coo_device(
            torch.from_numpy(inputs["drows"]),
            torch.from_numpy(inputs["dcols"]),
            torch.from_numpy(inputs[f"d{name}"]), (dn, dm))).nnz)
        entries(f"dev_{name}", got["s"])
    got = {}
    main("T", lambda: got.setdefault("t", a.transpose()).nnz)
    entries("T", got["t"])
    main("scaled", lambda: got.setdefault("s", a.scale_rows(
        inputs["scale"])).nnz)
    entries("scaled", got["s"])
    main("dense", lambda: a.todense().glom())
    main("rsums", lambda: a.rsums().numpy())
    x = torch.from_numpy(inputs["x"])
    xm = torch.from_numpy(inputs["xm"])
    for impl in ("windowed", "bcoo", "xla", "onehot", "pallas"):
        main(f"spmv_{impl}", lambda: a.spmv(x, impl=impl).numpy())
    for impl in ("bcoo", "xla"):
        main(f"spmm_{impl}", lambda: a.spmv(xm, impl=impl).numpy())
    # a split operand: read whole on every rank (counted at spmv)
    main("spmv_dist", lambda: a.spmv(from_numpy(inputs["x"])).numpy())

    pn = int(inputs["pr_n"])
    links = Sp.from_coo(inputs["pr_rows"], inputs["pr_cols"],
                        np.ones(inputs["pr_rows"].shape[0], np.float32),
                        (pn, pn))
    main("trans", lambda: links.transition().nnz)
    entries("trans", links.transition())
    main("pagerank", lambda: pagerank(links, num_iter=20))

    # checkpoints: this mesh writes a's entries, and reads the one the
    # parent wrote in one process from the same COO
    main("save", lambda: ckpt.save_sparse(os.path.join(workdir, "saved"),
                                          a) or 0)
    got = {}
    main("load", lambda: got.setdefault("l", ckpt.load_sparse(
        inputs["one_ckpt"].item())).nnz)
    entries("load", got["l"])

    # matrix_fact: the entry stream gathered once at its site; rmse from
    # each rank's entries and one all-reduce
    R = Sp.from_coo(inputs["mf_rows"], inputs["mf_cols"], inputs["mf_vals"],
                    (48, 40))
    uv = {}
    main("mf", lambda: np.concatenate([f.ravel() for f in uv.setdefault(
        "f", matrix_fact.sgd_matrix_factorization(
            R, k=4, num_epochs=2, batch=64))]))
    main("rmse", lambda: np.array(matrix_fact.rmse(R, *uv["f"])))

    # masked sorts of rows: each rank's rows hold the sort axis whole
    md = MaskedDistArray(from_numpy(inputs["md"], tiling=Tiling(("x", None))),
                         from_numpy(inputs["mm"], tiling=Tiling(("x", None))))
    srt = masked_sort(md, axis=1)
    main("msort_data", lambda: srt.data.glom())
    main("msort_mask", lambda: srt.mask.glom())
    main("margsort", lambda: masked_argsort(md, axis=1).glom())
    return out, mat
'''

_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import json
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
out, mat = ns["run_cases"](inputs, os.environ["OUT"])
out["mesh"] = np.array([mesh.shape["x"], mesh.shape["y"], mesh.coords["x"],
                        mesh.coords["y"]])
st.shutdown()
np.savez(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.npz"), **out)
with open(os.path.join(os.environ["OUT"], f"mat{mesh.rank}.json"), "w") as f:
    json.dump(mat, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


def _shape(world: int):
    return (2, 1) if world == 2 else (2, 2)


def _inputs(world: int, tmp_path) -> dict:
    rng = np.random.RandomState(500 + world)
    n, m, nnz = 600, 500, 6000
    rows, cols = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    rows[:900], cols[:900] = rows[900:1800], cols[900:1800]  # duplicates
    dn, dm, heavy, rest = 70, 60, 100_000, 3001
    drows = np.concatenate([rng.randint(0, dn, rest // 2), np.full(heavy, 9),
                            rng.randint(0, dn + 4, rest - rest // 2)])
    dcols = np.concatenate([rng.randint(0, dm, rest // 2),
                            np.full(heavy, 13),
                            rng.randint(0, dm, rest - rest // 2)])
    pn = 512
    md = rng.randn(8, 24).astype(np.float32)
    md[2, 5] = md[2, 7]  # a tie
    return {
        "shape": np.array([n, m]), "rows": rows, "cols": cols,
        "vals": rng.randn(nnz).astype(np.float32),
        "dshape": np.array([dn, dm]),
        "drows": drows.astype(np.int32), "dcols": dcols.astype(np.int32),
        "dexact": (rng.randint(1, 64, drows.shape[0]) / 8.0).astype(
            np.float32),
        "dnoisy": rng.rand(drows.shape[0]).astype(np.float32),
        "scale": rng.rand(n).astype(np.float32),
        "x": rng.rand(m).astype(np.float32),
        "xm": rng.rand(m, 3).astype(np.float32),
        "pr_rows": np.repeat(np.arange(pn), 8), "pr_n": np.array(pn),
        "pr_cols": rng.randint(0, pn, pn * 8),
        "mf_rows": rng.randint(0, 48, 700), "mf_cols": rng.randint(0, 40, 700),
        "mf_vals": (rng.randint(1, 6, 700)).astype(np.float32),
        "md": md, "mm": rng.rand(8, 24) < 0.3,
        "one_ckpt": np.array(str(tmp_path / "one")),
    }


def _launch(world: int, tmp_path, inputs: dict):
    path = tmp_path / "inputs.npz"
    np.savez(path, **inputs)
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, INPUTS=str(path), OUT=str(tmp_path),
                   CASES=_CASES,
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def join() -> list:
        import json

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
        out = []
        for r in range(world):
            res = dict(np.load(tmp_path / f"rank{r}.npz"))
            with open(tmp_path / f"mat{r}.json") as f:
                res["mat"] = json.load(f)
            out.append(res)
        return out

    return join


def _port(inputs: dict, shape, workdir):
    """The cases on the port's logical mesh of ``shape``."""
    from spartan_tpu_torch.parallel import mesh as mesh_t

    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh(shape, "cpu")):
            ns = {}
            exec(_CASES, ns)
            return ns["run_cases"](inputs, str(workdir))[0]
    finally:
        mesh_t.set_default_device(prev)


def _write_one_process_checkpoint(inputs: dict, tmp_path) -> None:
    """The COO saved from one process (a 1x1 logical mesh), which the
    group loads."""
    from spartan_tpu_torch.array.sparse import SparseDistArray as SpT
    from spartan_tpu_torch.parallel import mesh as mesh_t
    from spartan_tpu_torch.utils import checkpoint as ckpt_t

    n, m = (int(v) for v in inputs["shape"])
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1), "cpu")):
        sp = SpT.from_coo(inputs["rows"], inputs["cols"], inputs["vals"],
                          (n, m))
        ckpt_t.save_sparse(str(tmp_path / "one"), sp)


def _jax(inputs: dict, world: int) -> dict:
    """The JAX package's sparse array on the 8-device CPU mesh cut to the
    group's shape."""
    mj = mesh_j.build_mesh(jax.devices()[:world], shape=_shape(world))
    want = {}

    def entries(name, sp):
        want[name + "_data"] = np.asarray(sp.data)
        want[name + "_rows"] = np.asarray(sp.rows)
        want[name + "_cols"] = np.asarray(sp.cols)
        want[name + "_meta"] = np.array([sp.nse, sp.nnz])

    n, m = (int(v) for v in inputs["shape"])
    with mesh_j.use_mesh(mj):
        a = SpJ.from_coo(inputs["rows"], inputs["cols"], inputs["vals"],
                         (n, m))
        entries("coo", a)
        dn, dm = (int(v) for v in inputs["dshape"])
        entries("dev_exact", SpJ.from_coo_device(
            jnp.asarray(inputs["drows"]), jnp.asarray(inputs["dcols"]),
            jnp.asarray(inputs["dexact"]), (dn, dm)))
        entries("T", a.transpose())
        entries("scaled", a.scale_rows(inputs["scale"]))
        want["dense"] = np.asarray(a.glom())
        want["rsums"] = np.asarray(a.rsums())
        want["spmv"] = np.asarray(a.spmv(jnp.asarray(inputs["x"])))
        want["spmm"] = np.asarray(a.spmv(jnp.asarray(inputs["xm"])))
        pn = int(inputs["pr_n"])
        links = SpJ.from_coo(inputs["pr_rows"], inputs["pr_cols"],
                             np.ones(inputs["pr_rows"].shape[0], np.float32),
                             (pn, pn))
        entries("trans", links.transition())
        want["pagerank"] = np.asarray(pagerank_j(links, num_iter=20))
    return want


_ENTRIES = ("coo", "dev_exact", "T", "scaled", "trans")
# every case that may gather, and where
_GATHERS = {"spmv_dist": {"spmv": 1}, "mf": {"matrix_fact_stream": 1}}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same_entries(r, ref, name, what):
    for part in ("data", "rows", "cols", "meta"):
        key = f"{name}_{part}"
        np.testing.assert_array_equal(r[key], ref[key],
                                      err_msg=f"{key} {what}")


def _check(r, want, logical, world):
    nx = _shape(world)[0]
    # bit for bit against the JAX package and the logical mesh
    for name in _ENTRIES:
        _same_entries(r, want, name, "jax")
    for name in _ENTRIES + ("dev_noisy", "load"):
        _same_entries(r, logical, name, "logical")
    # the checkpoint written in one process loads as the group built it
    for part in ("data", "rows", "cols", "meta"):
        np.testing.assert_array_equal(r[f"load_{part}"], r[f"coo_{part}"])
    # each rank stores its block of nse / nx entries of 12 bytes
    for name in _ENTRIES + ("dev_noisy", "load"):
        nse = int(r[f"{name}_meta"][0])
        assert int(r[f"{name}_bytes"]) == 12 * nse // nx, name
        assert int(logical[f"{name}_bytes"]) == 12 * nse, name
    np.testing.assert_array_equal(r["dense"], want["dense"])
    np.testing.assert_array_equal(r["dense"], logical["dense"])
    # partial sums merged in rank order: 1e-6 of the largest
    assert _rel(r["rsums"], want["rsums"]) <= 1e-6
    assert _rel(r["rsums"], logical["rsums"]) <= 1e-6
    for impl in ("windowed", "bcoo", "xla", "onehot", "pallas", "dist"):
        got = r[f"spmv_{impl}"]
        assert _rel(got, want["spmv"]) <= 1e-6, impl
        assert _rel(got, logical[f"spmv_{impl}"]) <= 1e-6, impl
    for impl in ("bcoo", "xla"):
        assert _rel(r[f"spmm_{impl}"], want["spmm"]) <= 1e-6, impl
    pr = want["pagerank"]
    assert np.abs(r["pagerank"] - pr).max() <= 1e-6 * pr.max()
    assert np.abs(r["pagerank"] - logical["pagerank"]).max() \
        <= 1e-6 * pr.max()
    # SGD on every rank from the gathered stream: the logical run's
    # factors; rmse's partials merged over the ranks
    np.testing.assert_array_equal(r["mf"], logical["mf"])
    assert _rel(r["rmse"], logical["rmse"]) <= 1e-6
    for key in ("msort_data", "msort_mask", "margsort"):
        np.testing.assert_array_equal(r[key], logical[key], err_msg=key)
    # nothing gathered but the two sites that read their operand whole
    for case, sites in r["mat"].items():
        assert sites == _GATHERS.get(case, {}), (case, sites)
    for case, sites in _GATHERS.items():
        assert r["mat"].get(case) == sites, case


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_arrays_keep_each_ranks_entries(world, tmp_path):
    inputs = _inputs(world, tmp_path)
    _write_one_process_checkpoint(inputs, tmp_path)
    join = _launch(world, tmp_path, inputs)
    want = _jax(inputs, world)  # while the children run
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the children's BLAS runs on one thread
    try:
        (tmp_path / "logical").mkdir()
        logical = _port(inputs, _shape(world), tmp_path / "logical")
    finally:
        torch.set_num_threads(threads)
    outs = join()
    for r in outs:
        _check(r, want, logical, world)
    for other in outs[1:]:
        for key, val in outs[0].items():
            if key not in ("mesh", "mat") and not key.endswith("_bytes"):
                np.testing.assert_array_equal(other[key], val, err_msg=key)
    # the group's checkpoint loads in one process as the group built it
    from spartan_tpu_torch.parallel import mesh as mesh_t
    from spartan_tpu_torch.utils import checkpoint as ckpt_t

    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((1, 1), "cpu")):
            back = ckpt_t.load_sparse(str(tmp_path / "saved"))
            got = [t.numpy() for t in (back.data, back.rows, back.cols)]
    finally:
        mesh_t.set_default_device(prev)
    for g, part in zip(got, ("data", "rows", "cols")):
        np.testing.assert_array_equal(g, outs[0][f"coo_{part}"], err_msg=part)
    assert back.nnz == int(outs[0]["coo_meta"][1])
