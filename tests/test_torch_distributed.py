"""The port over real ``torch.distributed`` gloo groups of CPU processes,
against the JAX package.

Each group test starts 2 or 4 processes with ``python -c`` (as
tests/test_multihost.py does); the children import torch and the port
only. Each child finds its group through the environment
(``COORDINATOR_ADDRESS`` naming a ``file://`` store under the test's
``tmp_path``, so pytest-xdist workers never share a port, with
``WORLD_SIZE`` and ``RANK``), checks ``initialize_distributed``'s
refusal without that environment and its re-entry, and runs on the
group mesh (2 ranks: 2x1, 4 ranks: 2x2): every collective inside
``shard_map``, ``dot_shardmap``, the group forms of the k-means,
segment, histogram and stencil kernels, ring and Ulysses attention,
``pipeline_grad`` and a config-3-shaped k-means at a small size. Every
rank must hold the same bits; rank 0's results are compared here with
the JAX package's on a mesh of the same shape (the 8-device CPU mesh
cut to the group's size), with the tolerances of tests/test_torch_spmd.py
(data movement and integer sums bit-equal, float sums 1e-6 relative,
k-means sums rtol 2e-5, GEMMs and attention 1e-4 / 2e-4, the stencil
rtol 1e-4 / atol 1e-5, pipeline gradients rtol 1e-4 / atol 1e-5).
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
from spartan_tpu.examples import kmeans as km_j
from spartan_tpu.kernels import histogram as khist_j
from spartan_tpu.kernels import kmeans as kk_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.kernels import segment as kseg_j
from spartan_tpu.kernels import stencil as kst_j
from spartan_tpu.ops import attention as att_j
from spartan_tpu.parallel import collectives as coll_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.parallel import pipeline as pipe_j
from spartan_tpu.utils.compat import shard_map as shard_map_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120

_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_tensor
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.kernels import histogram as kh
from spartan_tpu_torch.kernels import kmeans as kk
from spartan_tpu_torch.kernels import segment as ks
from spartan_tpu_torch.kernels import stencil as kst
from spartan_tpu_torch.obs.metrics import collective_totals
from spartan_tpu_torch.ops import attention as att
from spartan_tpu_torch.ops import segment as seg
from spartan_tpu_torch.parallel import collectives as coll
from spartan_tpu_torch.parallel import mesh as mm
from spartan_tpu_torch.parallel import pipeline as pipe
from spartan_tpu_torch.parallel import shard_map as sm

st.set_default_device("cpu")
inputs = np.load(os.environ["INPUTS"])
out = {}
addr = os.environ.pop("COORDINATOR_ADDRESS")
world = int(os.environ.pop("WORLD_SIZE"))
rank = int(os.environ.pop("RANK"))
assert st.initialize_distributed() is False  # no address in the env
assert not st.get_mesh().is_group
os.environ.update(COORDINATOR_ADDRESS=addr, WORLD_SIZE=str(world),
                  RANK=str(rank))
assert st.initialize([]) == []
assert st.initialize_distributed() is True  # re-entry: no second dial
mesh = st.get_mesh()
assert mesh.is_group and mesh.rank == rank
assert mesh.device == torch.device("cpu")
out["mesh"] = np.array([mesh.shape["x"], mesh.shape["y"],
                        mesh.coords["x"], mesh.coords["y"]])
status = mm.status()
assert (status["process_index"], status["process_count"]) == (rank, world)
assert status["backend"] == "gloo"

stacked = (("x", "y"), None, None)
x = torch.from_numpy(inputs["coll_x"])
CASES = {
    "all_reduce_add": lambda a, v: coll.all_reduce(v, a),
    "all_reduce_mean": lambda a, v: coll.all_reduce(v, a, "mean"),
    "all_reduce_max": lambda a, v: coll.all_reduce(v, a, "max"),
    "all_reduce_min": lambda a, v: coll.all_reduce(v, a, "min"),
    "all_gather_0": lambda a, v: coll.all_gather(v, a),
    "all_gather_1": lambda a, v: coll.all_gather(v, a, gather_axis=1),
    "reduce_scatter_0": lambda a, v: coll.reduce_scatter(v, a),
    "reduce_scatter_1": lambda a, v: coll.reduce_scatter(v, a,
                                                         scatter_axis=1),
    "all_to_all": lambda a, v: coll.all_to_all(v, a, split_axis=1,
                                               concat_axis=0),
    "ring_permute_fwd": lambda a, v: coll.ring_permute(v, a, 1),
    "ring_permute_back": lambda a, v: coll.ring_permute(v, a, -1),
}
for axis in ("x", "y"):
    for name, body in CASES.items():
        fn = (lambda b, body=body, axis=axis: body(axis, b)[None])
        out[f"coll_{name}_{axis}"] = sm.shard_map(
            fn, mesh, (Tiling(("x", "y")),), Tiling(stacked))(x).numpy()

a, b = torch.from_numpy(inputs["dot_a"]), torch.from_numpy(inputs["dot_b"])
out["dot_shardmap"] = st.dot_shardmap(from_tensor(a),
                                      from_tensor(b)).glom()

pts = torch.from_numpy(inputs["km_pts"])
cen = torch.from_numpy(inputs["km_cen"])
k = cen.shape[0]
kk.LAUNCHES = 0
s_, c_ = kk.assign_accumulate_sharded(pts, cen, k, int(inputs["km_valid"]))
out["km_sums"], out["km_cnt"] = s_.numpy(), c_.numpy()
out["km_step"] = kk.step(pts, cen, k).numpy()

vals = torch.from_numpy(inputs["seg_vals"])
ids = torch.from_numpy(inputs["seg_ids"])
for kseg in (12, 16):
    out[f"seg_{kseg}"] = ks.segment_sum_sharded(vals, ids, kseg).numpy()
    out[f"seg_op_{kseg}"] = seg.segment_sum(vals, ids, kseg,
                                            impl="pallas").numpy()

hist = kh.bincount_sharded(torch.from_numpy(inputs["hist_ids"]), 64)
assert hist.dtype == torch.int32
out["hist"] = hist.numpy()

img = torch.from_numpy(inputs["st_img"])
flt = torch.from_numpy(inputs["st_flt"])
h_axes = Tiling((None, "x", None, None))
out["stencil"] = kst.halo_stencil(img, flt, h_axes).numpy()
xe = from_tensor(img, tiling=h_axes)
out["stencil_expr"] = st.stencil(xe, from_tensor(flt)).glom()

# gradients through a whole (None-tiled) input, and a replicated output
# that differs between positions (position 0's block on both runners)
flt_g = flt.clone().requires_grad_(True)
(kst.halo_stencil_sharded(img, flt_g, h_axes) ** 2).sum().backward()
out["grad_none_tiled"] = flt_g.grad.numpy()
xg = x.clone().requires_grad_(True)
rep = sm.shard_map(lambda b: b.sum(0, keepdim=True), mesh,
                   (Tiling(("x", "y")),), Tiling((None, None)))(xg)
(rep * torch.arange(1.0, rep.numel() + 1).reshape(rep.shape)).sum().backward()
out["rep_out"], out["rep_grad"] = rep.detach().numpy(), xg.grad.numpy()

q, kq, v = (torch.from_numpy(inputs[f"att_{n}"]) for n in "qkv")
for causal in (False, True):
    out[f"ring_{causal}"] = att.ring_attention(q, kq, v, causal).numpy()
    out[f"ulysses_{causal}"] = att.ulysses_attention(q, kq, v,
                                                     causal).numpy()

ws, bs = torch.from_numpy(inputs["pp_w"]), torch.from_numpy(inputs["pp_b"])
mb, tgt = torch.from_numpy(inputs["pp_x"]), torch.from_numpy(inputs["pp_t"])
loss, (gw, gb) = pipe.pipeline_grad(
    lambda p, a: torch.tanh(a @ p[0] + p[1]),
    lambda a, b: torch.mean((a - b) ** 2), (ws, bs), mb, tgt)
out["pp_loss"], out["pp_gw"], out["pp_gb"] = (loss.numpy(), gw.numpy(),
                                              gb.numpy())

kk.LAUNCHES = 0
c3, assign = km.kmeans(from_tensor(torch.from_numpy(inputs["c3_pts"])),
                       int(inputs["c3_k"]), num_iter=4,
                       centers=inputs["c3_c0"])
out["c3_centers"], out["c3_assign"] = c3, assign

totals = collective_totals()
out["staged"] = np.array(totals["collective_host_staged_calls"])
out["calls"] = np.array(totals["collective_calls"])
st.shutdown()
assert not st.get_mesh().is_group
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
print("CHILD_OK", rank, flush=True)
"""


def _inputs(world: int) -> dict:
    rng = np.random.RandomState(world)
    nx, ny = (2, 1) if world == 2 else (2, 2)
    true = (rng.rand(4, 128) * 4.0).astype(np.float32)
    lab = rng.randint(0, 4, 2048)
    c3 = (true[lab] + 0.05 * rng.randn(2048, 128)).astype(np.float32)
    return {
        "coll_x": rng.randn(8 * nx, 8 * ny).astype(np.float32),
        "dot_a": rng.rand(16, 8).astype(np.float32),
        "dot_b": rng.rand(8, 12).astype(np.float32),
        "km_pts": rng.rand(4096, 128).astype(np.float32),
        "km_cen": rng.rand(8, 128).astype(np.float32),
        "km_valid": np.array(4096 - 300),
        "seg_vals": rng.randint(-8, 9, (1001, 16)).astype(np.float32),
        "seg_ids": rng.randint(-2, 20, 1001).astype(np.int32),
        "hist_ids": rng.randint(-4, 70, 10_003).astype(np.int32),
        "st_img": rng.rand(2, 32, 12, 8).astype(np.float32),
        "st_flt": rng.rand(3, 3, 8, 4).astype(np.float32),
        "att_q": (rng.randn(32, 4, 8) * 0.3).astype(np.float32),
        "att_k": (rng.randn(32, 4, 8) * 0.3).astype(np.float32),
        "att_v": (rng.randn(32, 4, 8) * 0.3).astype(np.float32),
        "pp_w": (rng.randn(nx, 8, 8) * 0.3).astype(np.float32),
        "pp_b": (rng.randn(nx, 8) * 0.1).astype(np.float32),
        "pp_x": rng.randn(4, 4, 8).astype(np.float32),
        "pp_t": (rng.randn(4, 4, 8) * 0.1).astype(np.float32),
        "c3_pts": c3,
        "c3_k": np.array(4),
        "c3_c0": (true + 0.05 * rng.randn(4, 128)).astype(np.float32),
        "c3_labels": lab,
    }


def _launch(world: int, tmp_path) -> tuple:
    """Start the child on ``world`` ranks; returns the inputs and a
    function that joins the children and returns every rank's
    results."""
    inputs = _inputs(world)
    path = tmp_path / "inputs.npz"
    np.savez(path, **inputs)
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, INPUTS=str(path), OUT=str(tmp_path),
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
        assert all(p.returncode is not None for p in procs)
        for rank, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and f"CHILD_OK {rank}" in log, \
                log[-3000:]
        return [dict(np.load(tmp_path / f"rank{r}.npz"))
                for r in range(world)]

    return inputs, join


def _jax_smap(fn, mesh, in_axes, out_axes, *xs, n_out=1):
    specs = tuple(tiling_j.Tiling(a).spec() for a in in_axes)
    out = tiling_j.Tiling(out_axes).spec()
    with mesh_j.use_mesh(mesh):
        res = jax.jit(shard_map_j(
            fn, mesh=mesh, in_specs=specs, out_specs=(out,) * n_out,
            check_vma=False))(*[jnp.asarray(x) for x in xs])
    return [np.asarray(r) for r in res]


_JAX_CASES = {
    "all_reduce_add": (lambda a, v: coll_j.all_reduce(v, a), False),
    "all_reduce_mean": (lambda a, v: coll_j.all_reduce(v, a, "mean"), False),
    "all_reduce_max": (lambda a, v: coll_j.all_reduce(v, a, "max"), True),
    "all_reduce_min": (lambda a, v: coll_j.all_reduce(v, a, "min"), True),
    "all_gather_0": (lambda a, v: coll_j.all_gather(v, a), True),
    "all_gather_1": (lambda a, v: coll_j.all_gather(v, a, gather_axis=1),
                     True),
    "reduce_scatter_0": (lambda a, v: coll_j.reduce_scatter(v, a), False),
    "reduce_scatter_1": (lambda a, v: coll_j.reduce_scatter(
        v, a, scatter_axis=1), False),
    "all_to_all": (lambda a, v: coll_j.all_to_all(v, a, split_axis=1,
                                                  concat_axis=0), True),
    "ring_permute_fwd": (lambda a, v: coll_j.ring_permute(v, a, 1), True),
    "ring_permute_back": (lambda a, v: coll_j.ring_permute(v, a, -1), True),
}


def test_initialize_distributed_without_an_address_does_nothing(monkeypatch):
    from spartan_tpu_torch.parallel import mesh as mesh_t

    for key in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    try:
        assert mesh_t.initialize_distributed() is False
        assert not mesh_t.get_mesh().is_group
    finally:
        mesh_t.set_default_device(prev)


def test_backend_choice_and_refusals(monkeypatch):
    from spartan_tpu_torch.parallel import mesh as mesh_t

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    with pytest.raises(RuntimeError, match="nccl"):
        mesh_t._pick_backend("nccl", cpu, 1)  # no NCCL here, or no card
    with pytest.raises(ValueError, match="unknown backend"):
        mesh_t._pick_backend("mpi", cpu, 1)
    assert mesh_t._pick_backend(None, cpu, 2) == "gloo"
    # more ranks than this host's cards and no LOCAL_WORLD_SIZE: several
    # hosts or shared cards cannot be told apart, so no guess is made
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        mesh_t._pick_backend(None, cuda, 16)
    assert mesh_t._pick_backend("gloo", cuda, 16) == "gloo"
    # a launcher's LOCAL_WORLD_SIZE decides: more local ranks than cards
    # share them over gloo
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    assert mesh_t._pick_backend(None, cuda, 16) == "gloo"
    if torch.distributed.is_nccl_available():
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
        assert mesh_t._pick_backend(None, cuda, 16) == "nccl"
        monkeypatch.delenv("LOCAL_WORLD_SIZE")
        assert mesh_t._pick_backend(None, cuda, 8) == "nccl"


def _thread_results(inputs: dict, world: int) -> dict:
    """The port's thread runner on a CPU logical mesh of the group's
    shape: the oracle of the group runner's gradients."""
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.kernels import stencil as kst_t
    from spartan_tpu_torch.parallel import mesh as mesh_t
    from spartan_tpu_torch.parallel import shard_map as sm_t

    mt = mesh_t.build_mesh((2, 1) if world == 2 else (2, 2), "cpu")
    img = torch.from_numpy(inputs["st_img"])
    flt = torch.from_numpy(inputs["st_flt"]).requires_grad_(True)
    (kst_t.halo_stencil_sharded(img, flt, Tiling((None, "x", None, None)),
                                mesh=mt) ** 2).sum().backward()
    x = torch.from_numpy(inputs["coll_x"]).requires_grad_(True)
    rep = sm_t.shard_map(lambda b: b.sum(0, keepdim=True), mt,
                         (Tiling(("x", "y")),), Tiling((None, None)))(x)
    (rep * torch.arange(1.0, rep.numel() + 1).reshape(rep.shape)).sum() \
        .backward()
    return {"grad_none_tiled": flt.grad.numpy(),
            "rep_out": rep.detach().numpy(), "rep_grad": x.grad.numpy()}


def _jax_results(inputs: dict, world: int) -> dict:
    """The JAX package's results on a mesh of the group's shape."""
    nx, ny = (2, 1) if world == 2 else (2, 2)
    mj = mesh_j.build_mesh(jax.devices()[:world], shape=(nx, ny))
    want = {}
    names = sorted(_JAX_CASES)
    for axis in ("x", "y"):
        # every case in one program: one compile per axis
        outs = _jax_smap(
            lambda v, axis=axis: tuple(_JAX_CASES[n][0](axis, v)[None]
                                       for n in names),
            mj, [("x", "y")], (("x", "y"), None, None), inputs["coll_x"],
            n_out=len(names))
        want.update({f"coll_{n}_{axis}": o for n, o in zip(names, outs)})
    FLAGS_J.native_kernels = "on"
    try:
        with mesh_j.use_mesh(mj):
            want["dot_shardmap"] = st_j.dot_shardmap(
                st_j.from_numpy(inputs["dot_a"]),
                st_j.from_numpy(inputs["dot_b"])).glom()
            pts, cen = (jnp.asarray(inputs["km_pts"]),
                        jnp.asarray(inputs["km_cen"]))
            k = cen.shape[0]
            sj, cj = kk_j.assign_accumulate(
                pts, cen, k, valid_rows=int(inputs["km_valid"]), mesh=mj)
            want["km_sums"], want["km_cnt"] = np.asarray(sj), np.asarray(cj)
            want["km_step"] = np.asarray(kk_j.step(pts, cen, k))
            vals = inputs["seg_vals"]
            for kseg in (12, 16):
                sel = reg_j.select("segment_sum", vals.shape, np.float32,
                                   tiling_j.row(2), mj, force=True,
                                   num_segments=kseg)
                want[f"seg_{kseg}"] = np.asarray(kseg_j.segment_sum_sharded(
                    jnp.asarray(vals), jnp.asarray(inputs["seg_ids"]), kseg,
                    sel, mesh=mj))
            ids = inputs["hist_ids"]
            sel = reg_j.select("bincount", ids.shape, ids.dtype,
                               tiling_j.row(1), mj, length=64)
            want["hist"] = np.asarray(khist_j.bincount_sharded(
                jnp.asarray(ids), 64, sel, mesh=mj))
            h_axes = tiling_j.Tiling((None, "x", None, None))
            img, flt = inputs["st_img"], inputs["st_flt"]
            sel = reg_j.select("stencil", img.shape, img.dtype, h_axes, mj,
                               stride=(1, 1), padding="SAME",
                               kshape=(3, 3), out_channels=4)
            want["stencil"] = np.asarray(kst_j.halo_stencil(
                jnp.asarray(img), jnp.asarray(flt), h_axes, sel, mesh=mj))
            q, kq, v = (inputs[f"att_{n}"] for n in "qkv")
            for causal in (False, True):
                want[f"ring_{causal}"] = np.asarray(att_j.ring_attention(
                    q, kq, v, causal=causal))
                want[f"ulysses_{causal}"] = np.asarray(
                    att_j.ulysses_attention(q, kq, v, causal=causal))
            loss, grads = pipe_j.pipeline_grad(
                lambda p, a: jnp.tanh(a @ p[0] + p[1]),
                lambda a, b: jnp.mean((a - b) ** 2),
                (jnp.asarray(inputs["pp_w"]), jnp.asarray(inputs["pp_b"])),
                jnp.asarray(inputs["pp_x"]), jnp.asarray(inputs["pp_t"]))
            want["pp_loss"] = float(loss)
            want["pp_gw"], want["pp_gb"] = (np.asarray(grads[0]),
                                            np.asarray(grads[1]))
            FLAGS_J.native_kernels = "off"  # the JAX example's map2 form
            cj3, aj3 = km_j.kmeans(st_j.from_numpy(inputs["c3_pts"]),
                                   int(inputs["c3_k"]), num_iter=4,
                                   centers=inputs["c3_c0"])
            want["c3_centers"], want["c3_assign"] = (np.asarray(cj3),
                                                     np.asarray(aj3))
    finally:
        FLAGS_J.native_kernels = "auto"
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_group_matches_jax(world, tmp_path):
    inputs, join = _launch(world, tmp_path)
    want = _jax_results(inputs, world)  # while the children run
    threads = _thread_results(inputs, world)
    outs = join()
    nx, ny = (2, 1) if world == 2 else (2, 2)
    r0 = outs[0]
    # every rank holds the same bits of every result
    for other in outs[1:]:
        for key, val in r0.items():
            if key != "mesh":
                np.testing.assert_array_equal(other[key], val, err_msg=key)
    coords = sorted(tuple(o["mesh"]) for o in outs)
    assert coords == sorted((nx, ny, r // ny, r % ny) for r in range(world))
    assert int(r0["staged"]) == 0  # CPU tensors are never staged
    assert int(r0["calls"]) > 0

    for name, (_, exact) in _JAX_CASES.items():
        for axis in ("x", "y"):
            key = f"coll_{name}_{axis}"
            if exact:
                np.testing.assert_array_equal(r0[key], want[key], key)
            else:
                np.testing.assert_allclose(r0[key], want[key], rtol=1e-6,
                                           atol=1e-6, err_msg=key)
    np.testing.assert_allclose(r0["dot_shardmap"], want["dot_shardmap"],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["km_sums"], want["km_sums"], rtol=2e-5)
    np.testing.assert_array_equal(r0["km_cnt"], want["km_cnt"])
    np.testing.assert_allclose(r0["km_step"], want["km_step"], rtol=2e-5,
                               atol=1e-6)
    for kseg in (12, 16):
        np.testing.assert_array_equal(r0[f"seg_{kseg}"], want[f"seg_{kseg}"])
        np.testing.assert_array_equal(r0[f"seg_op_{kseg}"],
                                      want[f"seg_{kseg}"])
    np.testing.assert_array_equal(r0["hist"], want["hist"])
    for key in ("stencil", "stencil_expr"):
        np.testing.assert_allclose(r0[key], want["stencil"], rtol=1e-4,
                                   atol=1e-5)
    for causal in (False, True):
        for key in (f"ring_{causal}", f"ulysses_{causal}"):
            np.testing.assert_allclose(r0[key], want[key], rtol=2e-4,
                                       atol=2e-5)
    # a None-tiled input's gradient sums over the ranks (float order
    # differs from the thread runner's: 1e-5); a replicated output that
    # differs between positions is position 0's, value and gradient
    np.testing.assert_allclose(r0["grad_none_tiled"],
                               threads["grad_none_tiled"], rtol=1e-5,
                               atol=1e-5)
    for key in ("rep_out", "rep_grad"):
        np.testing.assert_array_equal(r0[key], threads[key], key)
    assert not r0["rep_grad"][8:].any()  # only position 0's rows
    np.testing.assert_allclose(r0["pp_loss"], want["pp_loss"], rtol=1e-5)
    for key in ("pp_gw", "pp_gb"):
        np.testing.assert_allclose(r0[key], want[key], rtol=1e-4, atol=1e-5)
    # well-separated clusters: the same assignments (C22)
    np.testing.assert_array_equal(r0["c3_assign"], want["c3_assign"])
    np.testing.assert_array_equal(r0["c3_assign"], inputs["c3_labels"])
    np.testing.assert_allclose(r0["c3_centers"], want["c3_centers"],
                               atol=1e-4)
