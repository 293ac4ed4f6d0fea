"""The SDC sentinel of the port (``resilience/integrity.py``), on the CPU.

* the CRC32 of each logical block equals the JAX package's
  ``shard_checksums`` record (same index key, same position id, same
  CRC) on 8x1 and on 4x2 for tilings that give every position a block;
* ``flip_bit`` gives the JAX package's flipped array;
* strikes, quarantine and exoneration follow the JAX package's sequence
  (``note_violation``, fed the same implications);
* end to end on one CPU "card": the rotated mesh is a permutation of
  the logical positions and its re-walk computes the same values, so a
  healthy check is quiet and bit-equal; an injected flip is caught, the
  corrupt result never returned and the clean retry's is; the cadence
  rides ``FLAGS.profile_sample_every``; a position corrupting every
  sampled walk is quarantined after the strike count, and the loop
  finishes bit-equal to a clean run through the same quarantine;
* on a group mesh the check refuses to run (ROADMAP A10).
"""

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.resilience import integrity as integrity_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.analysis import plan_audit
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import elastic as elastic_t
from spartan_tpu_torch.resilience import engine as engine_t
from spartan_tpu_torch.resilience import integrity as integrity_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

A = np.arange(64, dtype=np.float32).reshape(8, 8)


@pytest.fixture(autouse=True)
def _world():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    names = ("retry_backoff_s", "integrity_check", "sdc_quarantine_strikes",
             "profile_sample_every")
    saved = {n: (getattr(FLAGS_T, n), getattr(FLAGS_J, n)) for n in names}
    FLAGS_T.retry_backoff_s = 0.0
    for mod in (integrity_t, integrity_j):
        mod.reset()
    engine_t.reset()
    st_t.chaos_clear()
    yield
    st_t.chaos_clear()
    for mod in (integrity_t, integrity_j):
        mod.reset()
    engine_t.reset()
    base_t.clear_plan_cache()
    mesh_t.reset_epoch_for_tests()
    for n, (vt, vj) in saved.items():
        setattr(FLAGS_T, n, vt)
        setattr(FLAGS_J, n, vj)
    mesh_t.set_default_device(prev)


def _counter(name):
    return st_t.metrics()["counters"].get(name, 0)


def _arm(sample_every=1, strikes=3):
    FLAGS_T.integrity_check = True
    FLAGS_T.profile_sample_every = sample_every
    FLAGS_T.sdc_quarantine_strikes = strikes


CASES = [((8, 1), ("x", None)), ((4, 2), ("x", "y")), ((2, 4), ("y", "x"))]


@pytest.mark.parametrize("shape,axes", CASES)
def test_block_checksums_equal_jax(shape, axes):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        xj = st_j.from_numpy(A, tiling=tiling_j.Tiling(axes)).evaluate()
        want = integrity_j.shard_checksums(xj._jax)
    got = integrity_t.shard_checksums(torch.from_numpy(A.copy()),
                                      tiling_t.Tiling(axes),
                                      mesh_t.build_mesh(shape, "cpu"))
    assert got == want and len(got) == 8


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("victim,seed,occ", [(5, 7, 0), (0, 3, 9),
                                             (7, 11, 2)])
def test_flip_bit_gives_jax_flipped_array(shape, axes, victim, seed, occ):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        xj = st_j.from_numpy(A, tiling=tiling_j.Tiling(axes)).evaluate()
        want = np.asarray(integrity_j.flip_bit(xj._jax, victim, seed, occ))
    got = integrity_t.flip_bit(torch.from_numpy(A.copy()), victim, seed,
                               occ, [tiling_t.Tiling(axes)],
                               mesh_t.build_mesh(shape, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got.numpy() != A).sum()) == 1


def test_replicated_output_is_held_by_chunks():
    # one tensor holds every position's copy on one card: each position
    # answers for its row-major chunk, and the flip lands in the
    # victim's chunk only
    mesh = mesh_t.build_mesh((4, 2), "cpu")
    t = torch.from_numpy(A.copy())
    recs = integrity_t.shard_checksums(t, tiling_t.replicated(2), mesh)
    assert [k for k, _, _ in recs] == [("chunk", 8 * i, 8 * i + 8)
                                       for i in range(8)]
    bad = integrity_t.flip_bit(t, 6, 1, 0, [tiling_t.replicated(2)], mesh)
    diff = np.nonzero((bad.numpy() != A).reshape(-1))[0]
    assert len(diff) == 1 and 48 <= diff[0] < 56


STRIKE_SEQS = [
    [[2, 5]],
    [[6, 1], [6, 4], [6, 2]],
    [[i % 16] for i in range(64)] + [[100 + (i % 16)] for i in range(33)],
    [[3], [3, 4], [4], [4], [3]],
]


@pytest.mark.parametrize("seq", STRIKE_SEQS, ids=range(len(STRIKE_SEQS)))
def test_strikes_quarantine_exoneration_follow_jax(seq):
    for flags in (FLAGS_T, FLAGS_J):
        flags.sdc_quarantine_strikes = 3
    got = [integrity_t.note_violation(s) for s in seq]
    want = [integrity_j.note_violation(s) for s in seq]
    assert got == want
    st, sj = integrity_t.status(), integrity_j.status()
    for key in ("strikes", "exonerated", "window", "threshold"):
        assert st[key] == sj[key], key


# -- end to end ---------------------------------------------------------------


def test_rotated_mesh_permutes_positions_and_rewalks_the_same():
    mesh = mesh_t.build_mesh((4, 2), "cpu")
    rot = mesh_t.rotated_mesh(mesh, 3)
    assert rot.shape == mesh.shape and rot.device == mesh.device
    assert rot.ids == (3, 4, 5, 6, 7, 0, 1, 2)
    assert mesh_t.rotated_mesh(mesh_t.build_mesh((1, 1), "cpu")) is None
    with mesh_t.use_mesh(mesh):
        x = st_t.from_numpy(A, tiling=tiling_t.row(2))
        e = st_t.dot(x, x) * 0.5 + 1.0
        want = e.glom()
        plan = base_t.lookup_plan(base_t.plan_signature(
            st_t.dot(x, x) * 0.5 + 1.0, mesh)[0])
        again = integrity_t._rewalk(plan, base_t.plan_leaves(plan), rot)
    np.testing.assert_array_equal(again.numpy(), want)


def test_null_case_bit_equal_and_quiet():
    _arm(sample_every=1)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(A, tiling=tiling_t.block(2))
        out = (x * 3.0).glom()
    np.testing.assert_array_equal(out, A * 3.0)
    s = integrity_t.status()
    assert s["checks"] == 1 and s["violations"] == 0 and s["strikes"] == {}
    (verdict,) = integrity_t.current().values()
    assert verdict["verdict"] == "ok"


def test_injected_sdc_detected_retried_and_clean():
    _arm(sample_every=1)
    v0 = _counter("integrity_violations")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(A, tiling=tiling_t.block(2))
        with st_t.chaos("sdc@0#5", seed=7) as plan:
            out = (x * 3.0).glom()
    np.testing.assert_array_equal(out, A * 3.0)  # never the corrupt one
    assert [f["kind"] for f in plan.fired] == ["sdc"]
    s = integrity_t.status()
    assert s["violations"] == 1 and s["checks"] == 2
    assert "5" in s["strikes"] and s["quarantined"] == []
    assert _counter("integrity_violations") == v0 + 1
    summary = integrity_t.take_last_check()
    assert summary["violations"] == 1 and 5 in summary["suspects"]


def test_cadence_rides_profile_sample_every():
    _arm(sample_every=4)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(np.ones((8, 8), np.float32))
        for _ in range(8):
            (x + 1.0).glom()
    assert integrity_t.status()["checks"] == 2


def _steps(x, c, n):
    for _ in range(n):
        c = (st_t.as_expr(c) * 0.5 + x).evaluate()
    return c


def test_repeat_offender_quarantined_and_bit_equal_to_clean():
    """Position 6 corrupts every sampled walk (cadence 2): the third
    violation quarantines it, the caller rehomes its arrays onto the
    rebuilt mesh, and the run ends bit-equal to a clean run through the
    same quarantine."""
    _arm(sample_every=2, strikes=3)
    q0 = _counter("integrity_quarantines")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        base_t.clear_plan_cache()
        x = st_t.from_numpy(A, tiling=tiling_t.block(2)).evaluate()
        c = st_t.from_numpy(A * 0.1, tiling=tiling_t.block(2)).evaluate()
        # walk occurrences 1, 3 and 5 are the plan's 2nd, 4th and 6th
        # runs (each violation's retry is a run): each one is sampled
        with st_t.chaos("sdc@1#6,sdc@3#6,sdc@5#6", seed=3):
            c = _steps(x, c, 3)
            with pytest.raises(mesh_t.StaleMeshError):
                _steps(x, c, 3)
        hist = integrity_t.quarantine_history()
        assert [h["device"] for h in hist] == [6]
        assert hist[0]["strikes"] >= 3
        assert 6 not in mesh_t.get_mesh().ids
        elastic_t.rehome([x, c])
        out = _steps(x, c, 3).glom()
    assert _counter("integrity_quarantines") == q0 + 1
    # the clean run: the same steps, the same quarantine before the
    # step the sentinel interrupted
    FLAGS_T.integrity_check = False
    mesh_t.reset_epoch_for_tests()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        base_t.clear_plan_cache()
        x = st_t.from_numpy(A, tiling=tiling_t.block(2)).evaluate()
        c = st_t.from_numpy(A * 0.1, tiling=tiling_t.block(2)).evaluate()
        c = _steps(x, c, 3)
        elastic_t.quarantine_device(6)
        elastic_t.rehome([x, c])
        ref = _steps(x, c, 3).glom()
    np.testing.assert_array_equal(out, ref)


def test_group_mesh_refuses_the_check():
    _arm(sample_every=1)
    dm = plan_audit.dry_mesh(mesh_t.build_mesh((2, 1), "cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        integrity_t.maybe_check(None, None, (), False, dm)
    with pytest.raises(NotImplementedError):
        mesh_t.rotated_mesh(dm)
