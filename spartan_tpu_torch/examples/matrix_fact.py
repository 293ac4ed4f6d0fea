"""SGD matrix factorization on sparse ratings (port of
``spartan_tpu/examples/matrix_fact.py``).

R (users x items, sparse COO) ~= U @ V^T, trained by minibatch SGD over
the observed entries. The JAX package runs an epoch as one
``fori_loop`` over static-size batches; here an epoch is a Python loop
over the same batches, each a gather of factor rows, the error and two
``index_add_`` updates, all on the ratings' device with no host sync.

Padding entries (``row >= n_users``: the sparse array's own padding
and the stream's tail padding) must change nothing. The JAX package
drops their out-of-range scatters and zero-fills their gathers; torch
raises on an out-of-range index, so every padding entry is pointed at
one spare row past the end of each factor: its gathers are masked to 0
and its (zero) updates land in the spare row, so no real factor row
receives anything from it. ``index_add_`` on the card is atomic, so
duplicates of one row within a batch sum in an unspecified order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array.sparse import SparseDistArray


def _sgd_epoch(u, v, rows, cols, vals, valid, batch: int, lr: float,
               reg: float) -> None:
    """One epoch in place on the (n+1, k) factors (last row spare)."""
    for i in range(rows.shape[0] // batch):
        sl = slice(i * batch, (i + 1) * batch)
        r, c, x, ok = rows[sl], cols[sl], vals[sl], valid[sl]
        w = ok.to(u.dtype)
        ur = torch.where(ok[:, None], u[r], 0.0)
        vr = torch.where(ok[:, None], v[c], 0.0)
        err = ((ur * vr).sum(1) - x) * w
        gu = err[:, None] * vr + reg * ur * w[:, None]
        gv = err[:, None] * ur + reg * vr * w[:, None]
        u.index_add_(0, r, -lr * gu)
        v.index_add_(0, c, -lr * gv)


def _stream(ratings: SparseDistArray, idx: torch.Tensor):
    """Entries in ``idx`` order: rows and cols with padding pointed at
    the spare rows, values, and the mask of real entries. ``idx`` picks
    from the whole entry stream, so on a group mesh the stream is
    gathered once (counted at ``matrix_fact_stream``), as GSPMD gathers
    a split array for a replicated index into it."""
    n_users, n_items = ratings.shape
    data, rows, cols = ratings.whole_entries("matrix_fact_stream")
    r = rows[idx].long()
    c = cols[idx].long()
    ok = (r < n_users) & (c < n_items)
    return (torch.where(ok, r, n_users), torch.where(ok, c, n_items),
            data[idx], ok)


def sgd_matrix_factorization(
        ratings: SparseDistArray, k: int = 16, num_epochs: int = 10,
        lr: float = 0.02, reg: float = 0.02, batch: int = 4096,
        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Factor sparse ``ratings`` into (U, V) with U @ V^T ~= R.

    Returns dense (n_users, k) and (n_items, k) NumPy factors."""
    n_users, n_items = ratings.shape
    dev = ratings.device
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(k)
    u0 = rng.rand(n_users, k).astype(np.float32) * scale
    v0 = rng.rand(n_items, k).astype(np.float32) * scale
    u = torch.zeros((n_users + 1, k), dtype=torch.float32, device=dev)
    v = torch.zeros((n_items + 1, k), dtype=torch.float32, device=dev)
    u[:n_users] = torch.from_numpy(u0).to(dev)
    v[:n_items] = torch.from_numpy(v0).to(dev)

    # epoch order: one fixed shuffle of the entry stream (padding rides
    # along and changes nothing)
    perm = torch.from_numpy(rng.permutation(ratings.nse)).to(dev)
    rows, cols, vals, valid = _stream(ratings, perm)
    batch = min(batch, max(int(rows.shape[0]), 1))
    # pad the stream to a batch multiple with padding entries so the
    # tail is trained on rather than dropped
    pad = -rows.shape[0] % batch
    if pad:
        rows = torch.cat([rows, rows.new_full((pad,), n_users)])
        cols = torch.cat([cols, cols.new_full((pad,), n_items)])
        vals = torch.cat([vals, vals.new_zeros((pad,))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])

    for _ in range(num_epochs):
        _sgd_epoch(u, v, rows, cols, vals, valid, batch, lr, reg)
    return u[:n_users].cpu().numpy(), v[:n_items].cpu().numpy()


def rmse(ratings: SparseDistArray, u, v) -> float:
    """Root-mean-square error over the observed entries: each rank's
    partial sum of squares over the entries it stores, merged over the
    row axis on a group mesh."""
    dev = ratings.device
    u = torch.as_tensor(np.asarray(u, np.float32), device=dev)
    v = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    n_users = u.shape[0]
    blk = ratings.block
    valid = blk.rows < n_users
    r = torch.where(valid, blk.rows, 0).long()
    ur = torch.where(valid[:, None], u[r], 0.0)
    vr = v[blk.cols.long()]
    pred = (ur * vr).sum(1)
    se = torch.where(valid, (pred - blk.data) ** 2, 0.0).sum()
    se = ratings.merge_partials(se)
    return float(torch.sqrt(se / ratings.nnz))
