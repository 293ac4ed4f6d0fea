"""Parity of the port's applications with the JAX package, on the CPU:
regression, SVM, conjugate gradient, fuzzy k-means, SSVD, Lanczos, LSH,
LDA, ALS, the decompositions, SGD matrix factorization, the
sklearn-style estimators and the ``models`` namespace.

The same seeded numpy inputs, at ``tests/test_examples.py``'s and
``tests/test_sklearn_decomp.py``'s sizes, go through the JAX function
(on the virtual 8-device CPU mesh, 4x2 unless a case says otherwise)
and its port (on a logical mesh of the same shape, on the CPU). Both run
float32 with IEEE products (the JAX package at ``precision="highest"``,
the port with TF32 off), so the results differ only by summation order
and by LAPACK routes: each case states its tolerance.
"""

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev_dev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev_dev)


def _both(run, mesh=(4, 2)):
    """``run(st, "spartan_tpu")`` under the JAX mesh and
    ``run(st, "spartan_tpu_torch")`` under the port's logical mesh."""
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        out_j = run(st_j, "spartan_tpu")
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        out_t = run(st_t, "spartan_tpu_torch")
    return out_j, out_t


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.examples.{name}")


def _close(got, want, rtol):
    """Normwise relative error in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, (err, rtol)


def _canonical_columns(u):
    """Each column's sign flipped so its largest-magnitude entry is
    positive: QR and SVD fix columns only up to sign."""
    u = np.asarray(u, np.float64)
    idx = np.abs(u).argmax(axis=0)
    return u * np.sign(u[idx, np.arange(u.shape[1])])[None, :]


def _regression_data(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(256, 8).astype(np.float32)
    w_true = rng.randn(8).astype(np.float32)
    return x, x @ w_true


def _svm_data():
    rng = np.random.RandomState(3)
    x = rng.randn(256, 4).astype(np.float32)
    w_true = np.array([1.0, -2.0, 0.5, 1.5], np.float32)
    return x, np.sign(x @ w_true).astype(np.float32)


# -- regression, SVM, CG, fuzzy k-means --------------------------------------

# 200 float32 gradient steps on a well-conditioned problem: the two
# packages' products sum in other orders (~1e-7 relative a step) and
# the iteration contracts, so the weights agree to ~1e-7; 1e-5 normwise


def test_linear_regression_matches_jax():
    x, y = _regression_data()
    w_j, w_t = _both(lambda st, pkg: _mod(pkg, "regression").linear_regression(
        st.from_numpy(x), st.from_numpy(y), num_iter=200, lr=0.1))
    assert w_t.dtype == np.float32
    _close(w_t, w_j, 1e-5)


def test_ridge_regression_matches_jax():
    x, y = _regression_data()
    w_j, w_t = _both(lambda st, pkg: _mod(pkg, "regression").ridge_regression(
        st.from_numpy(x), st.from_numpy(y), num_iter=200, lr=0.1,
        alpha=0.01))
    _close(w_t, w_j, 1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["loop", "stepwise"])
def test_logistic_regression_matches_jax(fused):
    x, y = _regression_data(2)
    yb = (y > 0).astype(np.float32)
    w_j, w_t = _both(
        lambda st, pkg: _mod(pkg, "regression").logistic_regression(
            st.from_numpy(x), st.from_numpy(yb), num_iter=100, lr=0.5,
            fused=fused))
    _close(w_t, w_j, 1e-5)


def test_predict_logistic_matches_jax():
    x, y = _regression_data(2)
    w = np.random.RandomState(9).randn(8).astype(np.float32)
    p_j, p_t = _both(lambda st, pkg: _mod(pkg, "regression").predict_logistic(
        st.from_numpy(x), st.from_numpy(w)).glom())
    # one sigmoid of one float32 product per row
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=1e-7)


def test_svm_matches_jax():
    x, y = _svm_data()

    def run(st, pkg):
        mod = _mod(pkg, "svm")
        w = mod.svm(st.from_numpy(x), st.from_numpy(y), num_iter=150, lr=0.1)
        return w, mod.predict(st.from_numpy(x), st.from_numpy(w)).glom()

    (w_j, p_j), (w_t, p_t) = _both(run)
    _close(w_t, w_j, 1e-5)
    np.testing.assert_array_equal(p_t, p_j)


def test_conj_gradient_matches_jax():
    rng = np.random.RandomState(6)
    m = rng.randn(16, 16).astype(np.float32)
    a = m @ m.T + 16 * np.eye(16, dtype=np.float32)
    b = a @ rng.randn(16).astype(np.float32)
    x_j, x_t = _both(lambda st, pkg: _mod(pkg, "conj_gradient").conj_gradient(
        st.from_numpy(a), st.from_numpy(b), num_iter=32))
    # CG stops on the residual; both converge to float32 rounding of the
    # solution (condition number ~10)
    _close(x_t, x_j, 1e-5)


def test_fuzzy_kmeans_matches_jax():
    rng = np.random.RandomState(5)
    pts = np.concatenate([rng.randn(64, 2) + 4,
                          rng.randn(64, 2) - 4]).astype(np.float32)
    c_j, c_t = _both(lambda st, pkg: _mod(pkg, "fuzzy_kmeans").fuzzy_kmeans(
        st.from_numpy(pts), k=2, num_iter=15))
    _close(c_t, c_j, 1e-5)


# -- SSVD, Lanczos, LSH, LDA ------------------------------------------------


def test_ssvd_matches_jax():
    rng = np.random.RandomState(8)
    a = (rng.randn(32, 6) @ rng.randn(6, 24)).astype(np.float32)
    (u_j, s_j, vt_j), (u_t, s_t, vt_t) = _both(
        lambda st, pkg: _mod(pkg, "ssvd").ssvd(st.from_numpy(a), rank=6,
                                               n_power_iter=2))
    assert u_t.shape == (32, 6) and s_t.shape == (6,) and vt_t.shape == (6, 24)
    # singular values and U S V^T do not depend on the column signs that
    # LAPACK picks; U up to sign. Six QRs and one SVD of float32 data:
    # ~1e-6 relative
    _close(s_t, s_j, 1e-5)
    _close(u_t @ np.diag(s_t) @ vt_t, u_j @ np.diag(s_j) @ vt_j, 1e-5)
    _close(_canonical_columns(u_t), _canonical_columns(u_j), 1e-4)


def test_lanczos_svd_matches_jax():
    rng = np.random.RandomState(0)
    base = (rng.randn(48, 8) @ rng.randn(8, 32)).astype(np.float32)
    a = base + 0.01 * rng.randn(48, 32).astype(np.float32)
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(
        lambda st, pkg: _mod(pkg, "lanczos").lanczos_svd(
            st.from_numpy(a, tiling=st.Tiling(("x", None))), rank=4))
    # the recurrence is numpy on the host in both; only the products
    # (two float32 matvecs a step) differ in summation order
    _close(s_t, s_j, 1e-5)
    _close(_canonical_columns(u_t), _canonical_columns(u_j), 1e-4)
    _close(_canonical_columns(v_t), _canonical_columns(v_j), 1e-4)


def test_lsh_signatures_match_jax():
    rng = np.random.RandomState(11)
    pts = rng.randn(512, 32).astype(np.float32)
    bits_j, bits_t = _both(lambda st, pkg: _mod(pkg, "lsh").signatures(
        st.from_numpy(pts), n_bits=64, seed=4))
    assert bits_t.dtype == np.uint8 and bits_t.shape == (512, 64)
    # a sign bit flips where |x . r| is near the products' rounding: an
    # f32 dot of length 32 errs by at most ~32 * 2^-24 * |x| |r|, so
    # compare only where the float64 |x . r| exceeds 1e-5 |x| |r|
    r = np.random.RandomState(4).randn(32, 64).astype(np.float32)
    proj = pts.astype(np.float64) @ r.astype(np.float64)
    scale = (np.linalg.norm(pts, axis=1)[:, None]
             * np.linalg.norm(r, axis=0)[None, :])
    clear = np.abs(proj) > 1e-5 * scale
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(bits_t[clear], bits_j[clear])
    np.testing.assert_array_equal(bits_t[clear], (proj > 0)[clear])


def test_lsh_candidate_pairs_match_jax():
    rng = np.random.RandomState(2)
    base = rng.randn(7, 32).astype(np.float32)
    # rows 0 and 1 are near-duplicates; the rest random
    pts = np.vstack([base[0], base[0] + 0.01 * rng.randn(32)
                     .astype(np.float32), base[1:]]).astype(np.float32)

    def run(st, pkg):
        mod = _mod(pkg, "lsh")
        x = st.from_numpy(pts, tiling=st.Tiling(("x", None)))
        return (mod.candidate_pairs(x, n_bits=64, bands=16),
                mod.hamming_similarity(x, 0, 1))

    (pairs_j, sim_j), (pairs_t, sim_t) = _both(run)
    assert (0, 1) in pairs_t
    assert pairs_t == pairs_j
    assert sim_t == sim_j


def test_lda_matches_jax():
    rng = np.random.RandomState(1)
    d, w, k = 24, 16, 2
    counts = np.zeros((d, w), np.float32)
    for i in range(d):
        half = 0 if i < d // 2 else 1
        words = rng.randint(half * w // 2, (half + 1) * w // 2, size=40)
        np.add.at(counts[i], words, 1.0)

    def run(st, pkg):
        mod = _mod(pkg, "lda")
        ce = st.from_numpy(counts, tiling=st.Tiling(("x", None)))
        theta, phi = mod.lda(ce, k=k, num_iter=25, seed=3)
        return theta, phi, mod.log_likelihood(ce, theta, phi)

    (th_j, phi_j, ll_j), (th_t, phi_t, ll_t) = _both(run)
    # 25 EM steps of float32 sums that the host renormalizes
    _close(th_t, th_j, 1e-5)
    _close(phi_t, phi_j, 1e-5)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5)


# -- ALS, decompositions, matrix factorization ------------------------------


def test_als_matches_jax():
    rng = np.random.RandomState(7)
    u_true = rng.rand(24, 4).astype(np.float32)
    v_true = rng.rand(16, 4).astype(np.float32)
    mask = rng.rand(24, 16) < 0.7
    r_obs = (u_true @ v_true.T * mask).astype(np.float32)
    (u_j, v_j), (u_t, v_t) = _both(lambda st, pkg: _mod(pkg, "als").als(
        st.from_numpy(r_obs), k=4, num_iter=8, reg=0.05))
    # each half-step solves 4x4 normal equations whose entries differ
    # by summation order (~1e-7 relative); the solves amplify that by
    # their condition (~1e2 at reg 0.05) over 16 half-steps: 5e-5
    # measured, 5e-4 allowed
    _close(u_t, u_j, 5e-4)
    _close(v_t, v_j, 5e-4)


def test_cholesky_matches_jax():
    rng = np.random.RandomState(3)
    m = rng.randn(16, 16).astype(np.float32)
    a = m @ m.T + 16 * np.eye(16, dtype=np.float32)
    l_j, l_t = _both(lambda st, pkg: _mod(pkg, "decomposition").cholesky(
        st.from_numpy(a)).glom())
    assert np.array_equal(l_t, np.tril(l_t))
    _close(l_t, l_j, 1e-5)  # the factor is unique (positive diagonal)


def _qr_checks(q, r, q_j, r_j, a):
    # sign-free: Q R, Q^T Q, |R|, and Q, R up to column/row signs
    np.testing.assert_allclose(q @ r, a, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(a.shape[1]), atol=1e-5)
    _close(np.abs(r), np.abs(r_j), 1e-5)
    _close(_canonical_columns(q), _canonical_columns(q_j), 1e-5)


def test_qr_matches_jax():
    a = np.random.RandomState(4).randn(64, 8).astype(np.float32)
    (q_j, r_j), (q_t, r_t) = _both(lambda st, pkg: _mod(
        pkg, "decomposition").qr(st.from_numpy(a)))
    _qr_checks(q_t, r_t, q_j, r_j, a)


@pytest.mark.parametrize("rows,mesh", [
    (64, (4, 2)),   # 4 row shards of 16 x 8
    (64, (8, 1)),   # 8 row shards of 8 x 8
    (24, (4, 2)),   # shards of 6 rows would be wide: the plain QR
], ids=["4x2", "8x1", "fallback"])
def test_tsqr_matches_jax(rows, mesh):
    a = np.random.RandomState(4).randn(rows, 8).astype(np.float32)
    (q_j, r_j), (q_t, r_t) = _both(lambda st, pkg: _mod(
        pkg, "decomposition").tsqr(st.from_numpy(a)), mesh)
    _qr_checks(q_t, r_t, q_j, r_j, a)


def test_netflix_sgd_matches_jax():
    rng = np.random.RandomState(5)
    u_true = rng.rand(32, 4).astype(np.float32)
    v_true = rng.rand(24, 4).astype(np.float32)
    mask = rng.rand(32, 24) < 0.8
    r_obs = (u_true @ v_true.T * mask).astype(np.float32)
    (u_j, v_j), (u_t, v_t) = _both(
        lambda st, pkg: _mod(pkg, "decomposition").netflix_sgd(
            st.from_numpy(r_obs), k=4, num_iter=300, lr=0.5, reg=1e-4))
    # 300 full-gradient steps; measured 1e-7
    _close(u_t, u_j, 1e-5)
    _close(v_t, v_j, 1e-5)


def _ratings(st, n_users=40, n_items=30, seed=3):
    rng = np.random.RandomState(seed)
    u_true = rng.rand(n_users, 4).astype(np.float32)
    v_true = rng.rand(n_items, 4).astype(np.float32)
    r = u_true @ v_true.T
    obs = rng.rand(n_users, n_items) < 0.6
    rows, cols = np.nonzero(obs)
    return st.SparseDistArray.from_coo(rows, cols, r[rows, cols],
                                       (n_users, n_items))


def test_sgd_matrix_factorization_matches_jax():
    def run(st, pkg):
        mod = _mod(pkg, "matrix_fact")
        ratings = _ratings(st)
        u, v = mod.sgd_matrix_factorization(ratings, k=4, num_epochs=60,
                                            lr=0.05, reg=1e-4, batch=256)
        return u, v, mod.rmse(ratings, u, v), ratings.nse

    (u_j, v_j, e_j, n_j), (u_t, v_t, e_t, n_t) = _both(run)
    assert n_t == n_j  # the same padded stream, so the same permutation
    # 60 epochs of minibatch SGD; on the CPU index_add_ sums a batch's
    # duplicates in order, as XLA's scatter does: measured 3e-7
    _close(u_t, u_j, 1e-5)
    _close(v_t, v_j, 1e-5)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)


def test_matrix_fact_padding_changes_no_factor_row():
    """Padding entries carry ``row >= n_users`` and in-range columns; an
    item whose only entries are padding must keep its initial factor
    row bit for bit (a real entry's L2 term would shrink it)."""
    from spartan_tpu_torch.examples import matrix_fact

    n_users, n_items, k = 5, 7, 4
    rows = np.array([0, 1, 2, 3, 4, 0, 2])
    cols = np.array([1, 2, 3, 4, 5, 6, 6])  # item 0 has no rating
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        ratings = st_t.SparseDistArray.from_coo(
            rows, cols, np.linspace(1, 2, 7), (n_users, n_items))
        pad_cols = ratings.cols[ratings.rows >= n_users]
        assert pad_cols.numel() > 0 and bool((pad_cols == 0).any())
        u, v = matrix_fact.sgd_matrix_factorization(
            ratings, k=k, num_epochs=5, lr=0.5, reg=0.5, batch=3, seed=2)
    rng = np.random.RandomState(2)
    scale = 1.0 / np.sqrt(k)
    rng.rand(n_users, k)
    v0 = rng.rand(n_items, k).astype(np.float32) * scale
    np.testing.assert_array_equal(v[0], v0[0])
    assert not np.array_equal(v[1], v0[1])


# -- sklearn-style estimators and the models namespace ------------------------


def _two_blobs():
    rng = np.random.RandomState(0)
    return np.concatenate([rng.randn(64, 4) + 5,
                           rng.randn(64, 4) - 5]).astype(np.float32)


def test_kmeans_estimator_matches_jax():
    pts = _two_blobs()

    def run(st, pkg):
        km = _mod(pkg, "sklearn").KMeans(n_clusters=2, max_iter=5).fit(pts)
        return km.cluster_centers_, km.labels_, km.predict(pts)

    (c_j, l_j, p_j), (c_t, l_t, p_t) = _both(run)
    _close(c_t, c_j, 1e-6)
    np.testing.assert_array_equal(l_t, l_j)
    np.testing.assert_array_equal(p_t, p_j)


def test_linear_estimators_match_jax():
    x, y = _regression_data()
    yb = (y > 0).astype(np.float32)

    def run(st, pkg):
        sk = _mod(pkg, "sklearn")
        lr = sk.LinearRegression(max_iter=200, lr=0.1).fit(x, y)
        ridge = sk.Ridge(alpha=0.01, max_iter=200, lr=0.1).fit(x, y)
        clf = sk.LogisticRegression(max_iter=100, lr=0.5).fit(x, yb)
        return (lr.coef_, lr.predict(x), ridge.coef_, clf.coef_,
                clf.predict_proba(x), clf.predict(x))

    out_j, out_t = _both(run)
    for i in (0, 2, 3):
        _close(out_t[i], out_j[i], 1e-5)
    np.testing.assert_allclose(out_t[1], out_j[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t[4], out_j[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out_t[5], out_j[5])


def test_svc_and_nb_estimators_match_jax():
    x, y = _svm_data()
    rng = np.random.RandomState(2)
    counts = np.abs(rng.poisson(3, (128, 6))).astype(np.float32)
    counts[:64, :3] *= 5
    counts[64:, 3:] *= 5
    labels = np.r_[np.zeros(64), np.ones(64)].astype(np.int32)

    def run(st, pkg):
        sk = _mod(pkg, "sklearn")
        svc = sk.SGDSVC(max_iter=150).fit(x, y)
        nb = sk.MultinomialNB().fit(counts, labels)
        return (svc.coef_, svc.predict(x), nb.class_log_prior_,
                nb.feature_log_prob_, nb.predict(counts))

    out_j, out_t = _both(run)
    _close(out_t[0], out_j[0], 1e-5)
    np.testing.assert_array_equal(out_t[1], out_j[1])
    # integer counts sum exactly; the logs are one float32 op each
    np.testing.assert_allclose(out_t[2], out_j[2], rtol=1e-6)
    np.testing.assert_allclose(out_t[3], out_j[3], rtol=1e-6)
    np.testing.assert_array_equal(out_t[4], out_j[4])


def test_estimators_predict_from_jax_fitted_state():
    """State fitted by the JAX package, carried into the port's
    estimators: the same predictions."""
    from spartan_tpu.examples import sklearn as sk_j
    from spartan_tpu_torch.examples import sklearn as sk_t

    x, y = _regression_data()
    yb = (y > 0).astype(np.float32)
    xs, ys = _svm_data()
    pts = _two_blobs()
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(4, 2))):
        fitted = {
            "km": sk_j.KMeans(n_clusters=2, max_iter=5).fit(pts),
            "lin": sk_j.LinearRegression(max_iter=200, lr=0.1).fit(x, y),
            "log": sk_j.LogisticRegression(max_iter=100, lr=0.5).fit(x, yb),
            "svc": sk_j.SGDSVC(max_iter=150).fit(xs, ys)}
        want = {"km": fitted["km"].predict(pts),
                "lin": fitted["lin"].predict(x),
                "log": fitted["log"].predict_proba(x),
                "svc": fitted["svc"].predict(xs)}
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        km = sk_t.KMeans(n_clusters=2)
        km.cluster_centers_ = fitted["km"].cluster_centers_
        lin, log, svc = (sk_t.LinearRegression(), sk_t.LogisticRegression(),
                         sk_t.SGDSVC())
        lin.coef_ = fitted["lin"].coef_
        log.coef_ = fitted["log"].coef_
        svc.coef_ = fitted["svc"].coef_
        np.testing.assert_array_equal(km.predict(pts), want["km"])
        np.testing.assert_allclose(lin.predict(x), want["lin"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(log.predict_proba(x), want["log"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(svc.predict(xs), want["svc"])


def test_models_namespace_matches_jax():
    import spartan_tpu.models as models_j
    import spartan_tpu_torch.models as models_t

    assert models_t.__all__ == models_j.__all__
    for name in models_t.__all__:
        obj = getattr(models_t, name, None)
        assert obj is not None, name
        assert obj.__module__.startswith("spartan_tpu_torch."), name
