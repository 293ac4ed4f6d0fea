"""The port's state writes on the CPU: ``DistArray.update`` against the
JAX package for every reducer and dtype, donation (``donate()``,
``evaluate(donate=)``, ``loop(donate_init=)``), the checkpointed
``st.loop`` (segments, ``with_index`` offsets, resume, restores, the
restore budget), the error classifier, and the loop options that are not
ported yet.

``update`` results must equal the JAX package's bit for bit; a
segmented, restored or resumed loop must give the uninterrupted loop's
bits.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.resilience import classify as cls_j
from spartan_tpu_torch.examples import kmeans as km_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import classify as cls_t
from spartan_tpu_torch.resilience import loop_ckpt
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    prev_max = FLAGS_T.loop_restore_max
    yield
    FLAGS_T.loop_restore_max = prev_max
    mesh_t.set_default_device(prev)


# -- DistArray.update ---------------------------------------------------

REDUCERS = [None, "set", "add", "mul", "max", "min", np.add, np.multiply,
            np.maximum, np.minimum]
DTYPES = ["float32", "int32", "uint8", "int16", "uint16", "uint32",
          "uint64", "bool", "bfloat16"]


def _base(dtype, shape=(8, 6), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(*shape) < 0.5
    if dtype == "float32":
        return rng.randn(*shape).astype(np.float32)
    return rng.randint(0, 250, shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reducer", REDUCERS,
                         ids=lambda r: getattr(r, "__name__", str(r)))
def test_update_matches_jax(dtype, reducer):
    """A region write with each reducer, on a 4x2 mesh: a region block
    from an array (uint8/uint16 sums wrap), a scalar broadcast to a
    region, and a float block into an integer (or bfloat16) array (cast
    as ``jnp.asarray(data, dtype)`` casts)."""
    x = _base(dtype)
    block = _base(dtype, (3, 2), seed=1)
    floats = np.random.RandomState(2).rand(2, 6).astype(np.float32) * 9
    cases = [((slice(2, 5), slice(1, 3)), block),
             ((slice(0, 8), 4), 7 if dtype != "bool" else True),
             ((slice(6, 8), slice(0, 6)), floats)]

    def run(st):
        arr = st.from_numpy(x).evaluate()
        outs = [np.asarray(arr.update(r, d, reducer).glom())
                for r, d in cases]
        return outs + [np.asarray(arr.glom())]

    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(4, 2))):
        want = run(st_j)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        got = run(st_t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if dtype == "bfloat16":  # compare the bit patterns
            g, w = g.view(np.uint16), w.view(np.uint16)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[-1].astype(np.float64),
                                  x.astype(got[-1].dtype).astype(np.float64))


def test_update_keeps_tiling_and_rejects_bad_reducers():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        arr = st_t.from_numpy(_base("float32")).evaluate()
        out = arr.update((slice(0, 2), slice(0, 2)), 1.0)
        assert out.tiling == arr.tiling and out is not arr
        with pytest.raises(ValueError, match="unknown reducer"):
            arr.update((slice(0, 2), slice(0, 2)), 1.0, "xor")
        with pytest.raises(ValueError, match="unsupported reducer"):
            arr.update((slice(0, 2), slice(0, 2)), 1.0, np.subtract)


# -- donation -----------------------------------------------------------


def test_use_after_donate_raises_in_both_packages():
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    for st in (st_j, st_t):
        a = st.from_numpy(x).evaluate()
        out = (st.as_expr(a) * 2.0).evaluate(donate=[a])
        np.testing.assert_array_equal(np.asarray(out.glom()), x * 2.0)
        assert a.is_donated
        with pytest.raises(RuntimeError, match="used after donation"):
            a.glom()
        assert "donated" in repr(a)


def test_donate_method_releases_after_the_consuming_evaluation():
    x = np.ones((4, 4), np.float32)
    a = st_t.from_numpy(x).evaluate()
    held = a.tensor
    e = st_t.as_expr(a.donate()) + 1.0
    assert not a.is_donated  # nothing consumed it yet
    np.testing.assert_array_equal(e.glom(), x + 1.0)
    assert a.is_donated
    # the port never writes a donated tensor in place: a holder of the
    # tensor still reads what it held
    np.testing.assert_array_equal(held.numpy(), x)
    with pytest.raises(RuntimeError, match=r"donated at .*test_torch_update"):
        a.glom()


def test_donated_leaf_shared_by_two_exprs():
    """The second expr over a donated leaf raises instead of reading a
    released tensor; a cached plan over the same structure takes new
    leaves and stays right."""
    x = np.arange(6, dtype=np.float32)
    a = st_t.from_numpy(x).evaluate()
    e1 = st_t.as_expr(a) * 3.0
    e2 = st_t.as_expr(a) + 1.0
    np.testing.assert_array_equal(e1.evaluate(donate=[a]).glom(), x * 3.0)
    with pytest.raises(RuntimeError, match="used after donation"):
        e2.evaluate()
    b = st_t.from_numpy(x + 10.0).evaluate()
    base_t.reset_plan_stats()
    np.testing.assert_array_equal(
        (st_t.as_expr(b) * 3.0).evaluate().glom(), (x + 10.0) * 3.0)
    assert base_t.plan_stats()["plan_hits"] == 1
    assert not b.is_donated


def test_donate_of_an_unused_array_keeps_it():
    a = st_t.from_numpy(np.ones(4, np.float32)).evaluate()
    b = st_t.from_numpy(np.ones(4, np.float32)).evaluate()
    (st_t.as_expr(a) + 1.0).evaluate(donate=[b])
    assert not b.is_donated and not a.is_donated
    with pytest.raises(TypeError, match="donate expects DistArrays"):
        (st_t.as_expr(a) + 2.0).evaluate(donate=[np.ones(4)])


def test_force_and_tuple_evaluate_take_donate():
    x = np.full(4, 2.0, np.float32)
    a = st_t.from_numpy(x).evaluate()
    r1, r2 = st_t.tuple_of(st_t.as_expr(a) * 2.0,
                           st_t.as_expr(a) - 1.0).evaluate(donate=[a])
    np.testing.assert_array_equal(r1.glom(), x * 2.0)
    np.testing.assert_array_equal(r2.glom(), x - 1.0)
    assert a.is_donated
    b = st_t.from_numpy(x).evaluate()
    np.testing.assert_array_equal(
        (st_t.as_expr(b) + 1.0).force(donate=[b]).glom(), x + 1.0)
    assert b.is_donated


def test_loop_donate_init():
    x = np.full((3, 3), 1.0, np.float32)
    w0 = st_t.from_numpy(x).evaluate()
    out = st_t.loop(4, lambda w: w * 0.5 + 1.0, w0, donate_init=True)
    ref = x.copy()
    for _ in range(4):
        ref = ref * 0.5 + 1.0
    np.testing.assert_array_equal(out.glom(), ref)
    assert w0.is_donated
    w1 = st_t.from_numpy(x).evaluate()
    st_t.loop(4, lambda w: w * 0.5 + 1.0, w1).glom()
    assert not w1.is_donated


# -- the checkpointed loop -------------------------------------------------


def _kmeans_case(d, seed=0):
    rng = np.random.RandomState(seed)
    pts = st_t.from_numpy(rng.rand(2048, d).astype(np.float32))
    c0 = rng.rand(8, d).astype(np.float32)
    return pts, c0


@pytest.mark.parametrize("d", [128, 8], ids=["fused_pass", "map2"])
@pytest.mark.parametrize("every", [5, 3, 20])
def test_checkpointed_kmeans_is_bit_equal_to_the_uninterrupted_loop(
        tmp_path, d, every):
    pts, c0 = _kmeans_case(d)
    assert km_t._kernel_supports(2048, d, 8) == (d == 128)
    ref = st_t.loop(20, lambda c: km_t.kmeans_step(pts, c, 8),
                    st_t.from_numpy(c0)).glom()
    out = st_t.loop(20, lambda c: km_t.kmeans_step(pts, c, 8),
                    st_t.from_numpy(c0), checkpoint_every=every,
                    checkpoint_path=str(tmp_path))
    np.testing.assert_array_equal(out.glom(), ref)
    rec = out._resilience
    assert rec["segments"] == -(-20 // every) and rec["restores"] == 0
    if every >= 20:  # one segment: nothing to snapshot, as in JAX
        assert os.listdir(tmp_path) == []
        return
    with open(tmp_path / "LATEST.json") as f:
        assert json.load(f)["step"] == 20
    assert len([p for p in os.listdir(tmp_path)
                if p.startswith("step_")]) == 2


def test_with_index_offsets_and_multiple_carries(tmp_path):
    def body(i, a, b):
        return a + i.astype(np.float32) * 0.5, b * 1.5 + a

    a0 = st_t.from_numpy(np.zeros(4, np.float32))
    b0 = st_t.from_numpy(np.ones(4, np.float32))
    ref_a, ref_b = st_t.loop(11, body, a0, b0, with_index=True)
    out_a, out_b = st_t.loop(11, body, a0, b0, with_index=True,
                             checkpoint_every=4,
                             checkpoint_path=str(tmp_path))
    np.testing.assert_array_equal(out_a.glom(), ref_a.glom())
    np.testing.assert_array_equal(out_b.glom(), ref_b.glom())
    np.testing.assert_array_equal(out_a.glom(),
                                  np.full(4, 0.5 * sum(range(11))))


def test_resume_continues_from_the_last_snapshot(tmp_path):
    pts, c0 = _kmeans_case(128, seed=3)

    def body(c):
        return km_t.kmeans_step(pts, c, 8)

    ref = st_t.loop(20, body, st_t.from_numpy(c0)).glom()
    path = str(tmp_path)
    # a run that stopped after its iteration-10 snapshot
    st_t.loop(10, body, st_t.from_numpy(c0), checkpoint_every=5,
              checkpoint_path=path)
    out = st_t.loop(20, body, st_t.from_numpy(c0), checkpoint_every=5,
                    checkpoint_path=path, resume=path)
    np.testing.assert_array_equal(out.glom(), ref)
    assert out._resilience["resumed_from"] == 10
    assert out._resilience["segments"] == 2
    fresh = st_t.loop(20, body, st_t.from_numpy(c0),
                      resume=str(tmp_path / "empty"))
    np.testing.assert_array_equal(fresh.glom(), ref)


def test_port_resumes_a_jax_loop_snapshot(tmp_path):
    """The loop layout and the checkpoint format are the JAX package's:
    the port resumes a snapshot the JAX package wrote."""
    x = np.linspace(0.0, 1.0, 8).astype(np.float32)

    def body(w):
        return w * 0.5 + 1.0

    path = str(tmp_path)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(8, 1))):
        st_j.loop(10, body, st_j.from_numpy(x), checkpoint_every=5,
                  checkpoint_path=path).glom()
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        out = st_t.loop(15, body, st_t.from_numpy(x), checkpoint_every=5,
                        checkpoint_path=path, resume=path)
        ref = st_t.loop(15, body, st_t.from_numpy(x)).glom()
    assert out._resilience["resumed_from"] == 10
    np.testing.assert_array_equal(out.glom(), ref)


def _flaky(body, fail_on, exc):
    """``body`` that raises ``exc`` on the calls numbered in ``fail_on``
    (one call builds one segment)."""
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        if calls[0] in fail_on:
            raise exc
        return body(*args)

    return wrapped, calls


@pytest.mark.parametrize("exc", [RuntimeError("UNAVAILABLE: injected"),
                                 OSError("input/output error"),
                                 torch.cuda.OutOfMemoryError(
                                     "CUDA out of memory")],
                         ids=["transient", "io", "oom"])
def test_one_restore_after_a_failed_segment(tmp_path, exc):
    pts, c0 = _kmeans_case(128, seed=4)

    def body(c):
        return km_t.kmeans_step(pts, c, 8)

    ref = st_t.loop(20, body, st_t.from_numpy(c0)).glom()
    flaky, calls = _flaky(body, {3}, exc)
    out = st_t.loop(20, flaky, st_t.from_numpy(c0), checkpoint_every=5,
                    checkpoint_path=str(tmp_path))
    np.testing.assert_array_equal(out.glom(), ref)
    assert out._resilience["restores"] == 1
    assert calls[0] == 5  # segment 3 built twice


def test_a_fresh_run_ignores_an_earlier_runs_snapshots(tmp_path):
    """A fresh run into a directory holding a longer earlier run's
    snapshots: a fault before its first snapshot re-runs its held
    carries, a later fault restores its own snapshot, and pruning keeps
    its own last two snapshots."""
    pts, c0 = _kmeans_case(128, seed=5)

    def body(c):
        return km_t.kmeans_step(pts, c, 8)

    path = str(tmp_path)
    st_t.loop(30, body, st_t.from_numpy(c0 * 0.5), checkpoint_every=5,
              checkpoint_path=path)
    ref = st_t.loop(20, body, st_t.from_numpy(c0)).glom()
    flaky, calls = _flaky(body, {1, 4}, RuntimeError("UNAVAILABLE: x"))
    out = st_t.loop(20, flaky, st_t.from_numpy(c0), checkpoint_every=5,
                    checkpoint_path=path)
    np.testing.assert_array_equal(out.glom(), ref)
    assert out._resilience["restores"] == 2 and calls[0] == 6
    assert sorted(p for p in os.listdir(path) if p.startswith("step_")) \
        == ["step_00000015", "step_00000020"]


def test_failure_before_the_first_snapshot_reruns_held_carries(tmp_path):
    flaky, _ = _flaky(lambda w: w + 1.0, {1}, RuntimeError("ABORTED"))
    out = st_t.loop(6, flaky, st_t.from_numpy(np.zeros(2, np.float32)),
                    checkpoint_every=3, checkpoint_path=str(tmp_path))
    np.testing.assert_array_equal(out.glom(), [6.0, 6.0])
    assert out._resilience["restores"] == 1


@pytest.mark.parametrize("exc", [
    ValueError("bad shape"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
    cls_t.FatalMeshError("device gone")],
    ids=["deterministic", "illegal_address", "device_assert", "fatal"])
def test_deterministic_and_sticky_errors_propagate_at_once(tmp_path, exc):
    flaky, calls = _flaky(lambda w: w + 1.0, {2}, exc)
    with pytest.raises(type(exc)):
        st_t.loop(9, flaky, st_t.from_numpy(np.zeros(2, np.float32)),
                  checkpoint_every=3, checkpoint_path=str(tmp_path))
    assert calls[0] == 2  # no re-run


def test_restore_budget_exhausted(tmp_path):
    FLAGS_T.loop_restore_max = 2
    flaky, calls = _flaky(lambda w: w + 1.0, set(range(2, 100)),
                          RuntimeError("UNAVAILABLE"))
    with pytest.raises(RuntimeError, match="UNAVAILABLE") as info:
        st_t.loop(9, flaky, st_t.from_numpy(np.zeros(2, np.float32)),
                  checkpoint_every=3, checkpoint_path=str(tmp_path))
    assert any("2 restores exhausted at iteration 3" in n
               for n in info.value.__notes__)
    assert calls[0] == 4  # the first failure plus two restores


def test_snapshot_write_failure_propagates(tmp_path, monkeypatch):
    from spartan_tpu_torch.utils import checkpoint as ckpt

    def broken(*a, **k):
        raise OSError("no space left on device")

    st_t.loop(6, lambda w: w + 1.0, st_t.from_numpy(np.zeros(2, np.float32)),
              checkpoint_every=3, checkpoint_path=str(tmp_path))
    monkeypatch.setattr(ckpt, "save_tree", broken)
    with pytest.raises(OSError, match="no space"):
        st_t.loop(9, lambda w: w + 1.0,
                  st_t.from_numpy(np.zeros(2, np.float32)),
                  checkpoint_every=3, checkpoint_path=str(tmp_path))
    monkeypatch.undo()
    # the earlier run's last snapshot is still the one to restore
    step, carries = loop_ckpt.load_latest(str(tmp_path))
    assert step == 6
    np.testing.assert_array_equal(carries[0].glom(), [6.0, 6.0])


def test_checkpointed_loop_argument_errors(tmp_path):
    w = st_t.from_numpy(np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="checkpoint_path"):
        st_t.loop(6, lambda v: v + 1.0, w, checkpoint_every=3)
    with pytest.raises(TypeError, match="static"):
        st_t.loop(st_t.as_expr(np.int32(6)) + 0, lambda v: v + 1.0, w,
                  checkpoint_every=3, checkpoint_path=str(tmp_path))


@pytest.mark.parametrize("kw", [{"health": True}, {"early_exit": True},
                                {"stall_tol": 1e-3}])
def test_unported_loop_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        st_t.loop(3, lambda w: w + 1.0,
                  st_t.from_numpy(np.zeros(2, np.float32)), **kw)


# -- the classifier ---------------------------------------------------------

CLASSIFY = [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "oom"),
    (MemoryError(), "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (OSError("input/output error"), "io"),
    (FileNotFoundError("missing"), "io"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal_mesh"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal_mesh"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal_mesh"),
    (RuntimeError("cudaErrorLaunchFailure"), "fatal_mesh"),
    (RuntimeError("DATA_LOSS: shard gone"), "fatal_mesh"),
    (cls_t.FatalMeshError("dead"), "fatal_mesh"),
    (RuntimeError("UNAVAILABLE: connection"), "transient"),
    (RuntimeError("DEADLINE_EXCEEDED"), "transient"),
    (RuntimeError("NCCL error: remote process exited or there was a "
                  "network error"), "fatal_mesh"),
    (RuntimeError("integrity violation in shard 3"), "sdc"),
    (ValueError("shape mismatch"), "deterministic"),
    (TypeError("bad operand"), "deterministic"),
    (RuntimeError("INTERNAL: compiler bug"), "deterministic"),
]


@pytest.mark.parametrize("exc,kind", CLASSIFY,
                         ids=[f"{type(e).__name__}-{k}" for e, k in CLASSIFY])
def test_classify_table(exc, kind):
    assert cls_t.classify(exc) == kind


def test_classify_agrees_with_jax_on_shared_message_forms():
    for exc, kind in CLASSIFY:
        if isinstance(exc, cls_t.FatalMeshError) or "CUDA" in str(exc) \
                or "cuda" in str(exc) or "NCCL" in str(exc) or isinstance(
                    exc, torch.cuda.OutOfMemoryError):
            continue  # torch's own forms
        assert cls_j.classify(exc) == kind, exc


def test_injected_fault_kind_labels():
    e = RuntimeError("x")
    e.fault_kind = "transient"
    assert cls_t.classify(e) == "transient"
    e.fault_kind = "device_loss"
    assert cls_t.classify(e) == "fatal_mesh"
    e.fault_kind = "unknown"
    assert cls_t.classify(e) == "deterministic"
