"""The port's cost ledger and calibration (``obs/ledger.py``) against the
JAX package's, on the CPU.

``fit_profile`` is a least-squares fit over the ledger's rows, so the
same ``ingest`` / ``note_device_profile`` calls must give the same
factors in both packages (1e-12 relative) and the same fingerprint; a
profile must round-trip through ``save_profile`` / ``load_profile``; and
under the same profile the tiling DP must commit the JAX package's
tilings, on the 4x2, 8x1 and 2x4 logical meshes. Calibration changes the
plan key (one miss), never a value.
"""

import contextlib
import json

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.obs import ledger as ledger_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.expr import tiling_cost as cost_t
from spartan_tpu_torch.obs import ledger as ledger_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.parallel import redistribute as redist_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]
REL = 1e-12


@pytest.fixture(autouse=True)
def _clean_ledgers():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    for L, F in ((ledger_j, FLAGS_J), (ledger_t, FLAGS_T)):
        L.reset()
        L.set_profile(None)
        F.cost_calibration = False
    yield
    for L, F in ((ledger_j, FLAGS_J), (ledger_t, FLAGS_T)):
        L.reset()
        L.set_profile(None)
        F.cost_calibration = False
    mesh_t.set_default_device(prev)


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


ROWS = {
    "host_wall": [
        ("p1", {"map": 100.0, "reshard": 50.0}, 2.0),
        ("p2", {"map": 10.0, "reshard": 500.0}, 5.0),
        ("p3", {"map": 300.0, "contraction": 40.0}, 3.0),
    ],
    "collectives": [
        ("q1", {"all_gather": 4096.0, "map": 512.0, "psum": 64.0}, 0.010),
        ("q2", {"all_to_all": 2048.0, "reduce": 128.0}, 0.004),
        ("q3", {"all_gather": 1024.0, "all_to_all": 8192.0,
                "contraction": 1e6}, 0.050),
        ("q4", {"reduce_scatter": 300.0, "transpose": 700.0}, 0.002),
    ],
    "one_row": [("r1", {"slice": 12.0, "other": 4.0}, 1e-3)],
}


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_fit_profile_from_ingest_matches_jax(rows):
    for L in (ledger_j, ledger_t):
        for digest, comp, secs in ROWS[rows]:
            L.ingest(digest, comp, secs)
    pj, pt = ledger_j.fit_profile(), ledger_t.fit_profile()
    assert set(pt.factors) == set(pj.factors)
    assert all(_close(pt.factors[c], pj.factors[c]) for c in pj.factors)
    assert pt.fingerprint() == pj.fingerprint()
    assert pt.meta == pj.meta


def test_fit_profile_prefers_device_rows_like_jax():
    for L in (ledger_j, ledger_t):
        L.ingest("d1", {"map": 100.0, "contraction": 900.0}, 0.5)
        L.note_device_profile("d1", "replay", 0.4, 0.35,
                              {"map": 0.05, "contraction": 0.30})
        L.ingest("d2", {"reduce": 50.0, "map": 20.0}, 0.1)
    pj, pt = ledger_j.fit_profile(), ledger_t.fit_profile()
    assert pt.meta["source"] == pj.meta["source"] == "device_time"
    assert pt.meta["device_rows"] == pj.meta["device_rows"] == 2
    assert all(_close(pt.factors[c], pj.factors[c]) for c in pj.factors)


def test_save_load_round_trip(tmp_path):
    for L in (ledger_j, ledger_t):
        for digest, comp, secs in ROWS["collectives"]:
            L.ingest(digest, comp, secs)
    prof = ledger_t.fit_profile()
    path = ledger_t.save_profile(str(tmp_path / "cal.json"), prof)
    back = ledger_t.load_profile(path)
    assert back.factors == prof.factors
    assert back.fingerprint() == prof.fingerprint()
    assert ledger_t.active_profile() is back
    assert FLAGS_T.cost_calibration_fingerprint == back.fingerprint()
    # the JAX package reads the port's file and the other way
    assert ledger_j.load_profile(path).fingerprint() == back.fingerprint()
    pj = str(tmp_path / "cal_j.json")
    ledger_j.save_profile(pj, ledger_j.fit_profile())
    assert ledger_t.load_profile(pj).factors == \
        ledger_j.active_profile().factors
    # a version-1 file loads with the host-wall defaults
    v1 = str(tmp_path / "v1.json")
    with open(v1, "w") as f:
        json.dump({"version": 1, "factors": {"map": 2.0}}, f)
    old = ledger_t.load_profile(v1)
    assert old.meta == {"source": "host_wall", "device_rows": 0}
    with open(v1, "w") as f:
        json.dump({"version": 9, "factors": {}}, f)
    with pytest.raises(ValueError, match="version"):
        ledger_t.load_profile(v1)


def test_factors_reach_the_dp_only_under_the_flag():
    prof = ledger_t.CalibrationProfile({"reshard": 4.0, "map": 0.5})
    ledger_t.set_profile(prof)
    assert cost_t._cal_factors() is None
    assert redist_t._cal_factors() is None
    FLAGS_T.cost_calibration = True
    assert cost_t._cal_factors() == prof.factors
    assert redist_t._cal_factors() == prof.factors


def _dag(st, seed=0):
    rng = np.random.RandomState(seed)
    a = st.from_numpy(rng.rand(64, 48).astype(np.float32))
    b = st.from_numpy(rng.rand(48, 32).astype(np.float32))
    return (st.dot(st.transpose(st.dot(a, b)) * 2.0, a) + 1.0).sum(axis=1)


PROFILES = [{"reshard": 8.0, "contraction": 0.25},
            {"psum": 20.0, "map": 3.0, "transpose": 0.1},
            {"all_gather": 0.05, "all_to_all": 9.0, "reduce": 2.0}]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("factors", range(len(PROFILES)))
def test_calibrated_dp_commits_the_jax_tilings(factors, shape):
    fj = ledger_j.CalibrationProfile(PROFILES[factors])
    ft = ledger_t.CalibrationProfile(PROFILES[factors])
    ledger_j.set_profile(fj)
    ledger_t.set_profile(ft)
    FLAGS_J.cost_calibration = FLAGS_T.cost_calibration = True
    with _meshes(shape):
        rj = st_j.explain(_dag(st_j), cost=False)
        rt = st_t.explain(_dag(st_t), cost=False)
    key = lambda r: [(t["node"].split("#")[0], t["tiling"],  # noqa: E731
                      t.get("contraction")) for t in r.tilings]
    assert key(rt) == key(rj)
    assert _close(rt.dp_cost, rj.dp_cost)


def test_calibration_rekeys_the_plan_and_changes_no_value():
    # an earlier test of this worker may have planned this structure
    # under the same profile: count misses from an empty plan cache
    base_t.clear_plan_cache()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        plain = _dag(st_t).glom()
        base_t.reset_plan_stats()
        _dag(st_t).glom()
        assert base_t.plan_stats()["plan_hits"] == 1
        ledger_t.set_profile(ledger_t.CalibrationProfile(PROFILES[0]))
        FLAGS_T.cost_calibration = True
        base_t.reset_plan_stats()
        cal = _dag(st_t).glom()
        assert base_t.plan_stats()["plan_misses"] == 1
        np.testing.assert_array_equal(cal, plain)
        # another profile: another key
        ledger_t.set_profile(ledger_t.CalibrationProfile(PROFILES[1]))
        _dag(st_t).glom()
        assert base_t.plan_stats()["plan_misses"] == 2


def test_evaluate_feeds_the_ledger():
    # the predictions are recorded on a plan-cache miss: start without a
    # plan an earlier test of this worker built
    base_t.clear_plan_cache()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        for seed in range(3):
            _dag(st_t, seed).glom()
        r = st_t.explain(_dag(st_t))
    snap = st_t.ledger(validate=True)
    ent = snap["plans"][r.plan_key]
    assert ent["predicted"]["dp_cost"] == pytest.approx(r.dp_cost)
    # the plan's first walk is its one-time run (the JAX package's
    # compile, tests/test_ledger.py:125-126), kept out of the dispatches
    assert ent["measured"]["dispatch_count"] == 2
    assert ent["measured"]["compile_s"] > 0
    assert ent["measured"]["dispatch_min_s"] > 0
    assert ent["measured"]["flops"] == r.cost_analysis["flops"]
    # the memory governor's modeled card peak is the prediction; the
    # measured one comes only from a walk on the card (none here)
    assert ent["measured"]["xla_peak_bytes"] is None
    assert ent["predicted"]["peak_bytes"] == \
        r.data["memory"]["peak_bytes_card"] > 0
    assert set(snap["models"]) == {"tiling_dp", "peak_hbm", "service_time"}
    FLAGS_T.cost_ledger = False
    try:
        ledger_t.reset()
        with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
            _dag(st_t, 7).glom()
        assert st_t.ledger()["plans"] == {}
    finally:
        FLAGS_T.cost_ledger = True
