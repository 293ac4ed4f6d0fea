"""The proof that decides which user functions run on a rank's blocks
(``spartan_tpu_torch/expr/partition.py``).

Each accepted function is replayed on the row blocks of an even and an
uneven split, the blocks running in lockstep threads whose all-reduce
sums the blocks' partials, and held against the function run whole: an
elementwise or row-local result bit-equal where the blocks are whole
multiples of 64 rows (the host BLAS takes another path for a tail of
rows shorter than its group, so a row's bits depend on where its block
ends; an uneven split is held within 1e-6 relative), a partial sum
within 1e-5 relative, a mean over the rows (its sum all-reduced, then
divided) within 1e-6, a flip (a move of the mirrored rows) bit-equal on
every split. Each rejected function names its reason. An elementwise
program traced at the whole shapes is replayed on blocks, a size read
from a shape keeping its whole value. The decision is the same at every
position of a mesh, and a key traces once. The group runs against the
JAX package are in ``tests/test_torch_local_storage.py``.
"""

import functools

import threading

import numpy as np
import pytest
import torch

from spartan_tpu_torch.examples import als, fuzzy_kmeans, kmeans, naive_bayes
from spartan_tpu_torch.examples import regression, svm
from spartan_tpu_torch.expr import partition as pt
from spartan_tpu_torch.expr.builtins import _trace
from spartan_tpu_torch.expr.local import LocalCall, LocalInput
from spartan_tpu_torch.expr.map import proven_elementwise
from spartan_tpu_torch.expr.map2 import Map2Expr
from spartan_tpu_torch.parallel import mesh as mesh_t

RNG = np.random.RandomState(7)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


N, D, K = 4096, 16, 4


def _f32(*shape):
    return torch.from_numpy(RNG.rand(*shape).astype(np.float32))


X, X2 = _f32(N, D), _f32(N, D)
Y01 = (_f32(N) > 0.5).float()
W = torch.from_numpy(RNG.randn(D).astype(np.float32))
C = X[:K].clone()
L = torch.from_numpy(RNG.randn(K, D).astype(np.float32))
PV = torch.from_numpy(RNG.randn(K).astype(np.float32))
LABELS = torch.from_numpy(RNG.randint(0, K, N))
# ratings with ~40% missing, and the other factor of ALS's half-step
RATINGS = torch.from_numpy(
    (np.floor(RNG.rand(N, 48) * 5.0 + 1.0)
     * (RNG.rand(N, 48) > 0.4)).astype(np.float32))
FACTOR = torch.from_numpy((0.1 * RNG.rand(48, K)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _square(dtype):
    """An N x N operand for the trace (made on first use)."""
    g = torch.Generator().manual_seed(11)
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (N, N), generator=g,
                             dtype=torch.int32)
    return torch.rand((N, N), generator=g)


class _Sq:
    """The square operand of ``dtype``, made when a test first reads it
    (the parameter lists are built at import)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def get(self):
        return _square(self.dtype)


def _trace_at(offset):
    return lambda v: _trace(v, offset)


# (name, fn, operands, row dims, the result's state)
_ROWS = [
    ("linear_grad", regression._linear_kern, (X, Y01, W), (0, 0, None),
     pt.P),
    ("logistic_grad", regression._logistic_kern, (X, Y01, W), (0, 0, None),
     pt.P),
    ("svm_grad", lambda a, b, c: svm._svm_kern(a, b, c, 1e-3),
     (X, 2.0 * Y01 - 1.0, W), (0, 0, None), pt.W),
    ("fuzzy_kmeans_step", lambda p, c: fuzzy_kmeans._fuzzy_kern(p, c, 2.0),
     (X, C), (0, None), pt.P),
    ("kmeans_map2", kmeans._assign_and_accumulate(K), (X, C), (0, None),
     pt.P),
    ("predict_logistic", regression._predict_kern, (X, W), (0, None),
     pt.R(0)),
    ("predict_svm", svm._predict_kern, (X, W), (0, None), pt.R(0)),
    ("predict_nb", naive_bayes._predict_kern, (X, PV, L), (0, None, None),
     pt.R(0)),
    ("assign_points", kmeans._assign_kern, (X, C), (0, None), pt.R(0)),
    ("linear_layer", torch.nn.functional.linear, (X, L, PV),
     (0, None, None), pt.R(0)),
    ("elementwise", lambda a, b: a * b + b, (X, X2), (0, 0), pt.R(0)),
    ("naive_bayes_fit", naive_bayes._fit_kern(K), (X, LABELS), (0, 0),
     pt.P),
    # ALS's half-step: the other factor broadcast over the batch of rows,
    # one batched solve a rank
    ("als_solve_side", lambda r, o: als._solve_side(r, o, 0.1),
     (RATINGS, FACTOR), (0, None), pt.R(0)),
    # a mean over the rows: the sum all-reduced in the step, divided
    ("mean_over_rows", lambda a: a - a.mean(0), (X,), (0,), pt.R(0)),
    ("mean_all", lambda a: a - a.mean(), (X,), (0,), pt.R(0)),
    # a flip along the rows: the mirrored rows moved between the ranks
    ("flip", lambda a: a.flip(0), (X,), (0,), pt.R(0)),
    ("flip_both", lambda a, b: a.flip(0, 1) * b, (X, X2), (0, 0),
     pt.R(0)),
    # trace: the diagonal's elements in each rank's rows, a partial sum;
    # an int32 trace sums in int64, all-reduced before its wrap to int32
    ("trace_0", _trace_at(0), (_Sq(torch.float32),), (0,), pt.P),
    ("trace_p3", _trace_at(3), (_Sq(torch.float32),), (0,), pt.P),
    ("trace_m3", _trace_at(-3), (_Sq(torch.float32),), (0,), pt.P),
    ("trace_int_0", _trace_at(0), (_Sq(torch.int32),), (0,), pt.W),
    ("trace_int_p3", _trace_at(3), (_Sq(torch.int32),), (0,), pt.W),
    ("trace_int_m3", _trace_at(-3), (_Sq(torch.int32),), (0,), pt.W),
    # a multi-output op of whole operands: whole, each output read
    # through its getitem
    ("sort_whole", lambda a, v: a + torch.sort(v, 0).values, (X, W),
     (0, None), pt.R(0)),
    ("max_whole", lambda a, v: a + torch.max(v, 0).values, (X, L),
     (0, None), pt.R(0)),
    # a three-operand einsum contracting the rows: one partial sum
    ("einsum_3", lambda a, b, c: torch.einsum("ij,ik,il->jkl", a, b, c),
     (X[:, :8], X2[:, :8], X[:, 8:]), (0, 0, 0), pt.P),
]

# the all-reduces each plan makes inside its program (the output's own
# is the caller's): svm's `+ reg * w` meets its partial; a mean over the
# rows; an int trace's partial before its cast
_INNER = {"svm_grad": 1, "mean_over_rows": 1, "mean_all": 1,
          "trace_int_0": 1, "trace_int_p3": 1, "trace_int_m3": 1}
# a row-local result computed from all-reduced sums: the sum's order
# changes with the split
_ROW_TOL = {"mean_over_rows": 1e-6, "mean_all": 1e-6}
# pure moves of data: bit-equal on every split
_MOVES = {"flip", "flip_both"}


class _Lockstep:
    """An all-reduce over threads: each waits for every block's partial
    and returns their sum (in block order, the same on every thread)."""

    def __init__(self, n: int):
        self.bar = threading.Barrier(n, timeout=60)
        self.parts = [None] * n

    def reduce(self, i: int, t: torch.Tensor) -> torch.Tensor:
        self.parts[i] = t
        self.bar.wait()
        out = self.parts[0].clone()
        for p in self.parts[1:]:
            out = out + p
        self.bar.wait()
        return out


    def mirror(self, i: int, t: torch.Tensor, d: int, splits):
        """Each thread's reversed block ``t`` of an array split along
        ``d`` by ``splits``: its block of the flipped array (the
        mirrored rows, from the threads that hold them)."""
        self.parts[i] = t
        self.bar.wait()
        whole = torch.cat(self.parts[::-1], d)
        lo, hi = splits[i]
        out = whole.narrow(d, lo, hi - lo).clone()
        self.bar.wait()
        return out


def _replay(plan, operands, row_dims, splits):
    """Each block's program in its own thread; the blocks' results put
    back together by the output's state."""
    step = _Lockstep(len(splits))
    outs = [None] * len(splits)
    errs = []

    def one(i, lo, hi):
        try:
            blocks = [a[lo:hi] if d is not None else a
                      for a, d in zip(operands, row_dims)]
            out = plan.run(blocks, hi - lo, lambda t: step.reduce(i, t),
                           start=lo, move=lambda t, d: step.mirror(
                               i, t, d, splits))
            if plan.out_state == pt.P:
                out = step.reduce(i, out)
            outs[i] = out
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            step.bar.abort()

    threads = [threading.Thread(target=one, args=(i, lo, hi))
               for i, (lo, hi) in enumerate(splits)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    st = plan.out_state
    if st[0] == "R":
        return torch.cat(outs, st[1])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])  # every block the same whole
    return outs[0]


def _splits(n, sizes):
    out, lo = [], 0
    for s in sizes:
        out.append((lo, lo + s))
        lo += s
    assert lo == n
    return out


def _specs(operands):
    return [(tuple(a.shape), a.dtype) for a in operands]


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name,fn,operands,row_dims,state", _ROWS,
                         ids=[r[0] for r in _ROWS])
@pytest.mark.parametrize("sizes", [(2048, 2048), (1024,) * 4,
                                   (1403, 1365, 1328)],
                         ids=["two", "four", "uneven"])
def test_row_partition_accepts_and_replays(name, fn, operands, row_dims,
                                           state, sizes):
    operands = tuple(a.get() if isinstance(a, _Sq) else a for a in operands)
    plan = pt.rows(fn, _specs(operands), row_dims, N)
    assert not isinstance(plan, str), plan
    assert plan.out_state == state
    assert plan.inner_reduces == _INNER.get(name, 0)
    assert len(plan.moves) == (1 if name in _MOVES else 0)
    got = _replay(plan, operands, row_dims, _splits(N, sizes))
    want = fn(*operands)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name in _MOVES or not (want.dtype.is_floating_point
                              or want.dtype.is_complex):
        assert torch.equal(got, want)
    elif name in _ROW_TOL:
        assert _rel(got, want) <= _ROW_TOL[name]
    elif state in (pt.P, pt.W):
        assert _rel(got, want) <= 1e-5
    elif sizes[0] % 64 == 0:
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= 1e-6


def test_replay_holds_the_card_model_of_its_intermediates():
    # logistic_grad at a block of r rows: X @ w and the sigmoid live at
    # once (2 r floats), then the error (the sigmoid freed)
    plan = pt.rows(regression._logistic_kern, _specs((X, Y01, W)),
                   (0, 0, None), N)
    r = 1000
    assert plan.card_bytes(r) == 2 * r * 4
    # the elementwise a * b + b: the product, then the sum beside it
    plan = pt.rows(lambda a, b: a * b + b, _specs((X, X2)), (0, 0), N)
    assert plan.card_bytes(r) == 2 * r * D * 4


def test_the_naive_bayes_fit_replays_its_kernel_priced_by_its_shape():
    # under native_kernels=on both segment sums trace to the block
    # kernel's operator, a partial sum over the rows; the card model
    # prices each call from the operator's shape rule: the (K, D) counts,
    # the rows' ones and the (K,) class sizes live at once
    from spartan_tpu_torch.utils.config import FLAGS

    prev = FLAGS.native_kernels
    FLAGS.native_kernels = "on"
    try:
        plan = pt.rows(naive_bayes._fit_kern(K), _specs((X, LABELS)),
                       (0, 0), N)
    finally:
        FLAGS.native_kernels = prev
    ops = [str(s.node.target) for s in plan.steps]
    assert ops.count("spartan_tpu_torch.segment_sum_block.default") == 2
    assert plan.out_state == pt.P and plan.inner_reduces == 0
    r = 1000
    assert plan.card_bytes(r) == (K * D + r + K) * 4
    got = _replay(plan, (X, LABELS), (0, 0), _splits(N, (1024,) * 4))
    assert _rel(got, naive_bayes._fit_kern(K)(X, LABELS)) <= 1e-5


# (name, fn, operands, reason's start)
_ROW_REJECTS = [
    ("cumsum", lambda a: a.cumsum(0), (X,), "cumsum: along the rows"),
    ("outer_gram", lambda a: a @ a.T, (X,), "mm: operands split apart"),
    ("item", lambda a: a * a.sum().item(), (X,), "trace:"),
    ("to_host", lambda a: torch.from_numpy(a.cpu().numpy()), (X,), "trace:"),
    ("rand_like", lambda a: a + torch.rand_like(a), (X,), "random:"),
    ("unlisted_op", lambda a: torch.sort(a, 1).values, (X,), "no rule: sort"),
    # a diagonal's pieces are no rows: returned as they are, or met
    # with a split operand, they are rejected
    ("diagonal_out", lambda a: torch.diagonal(a[:, :16]), (X,),
     "output: a diagonal's pieces"),
    ("diagonal_rows", lambda a: torch.diagonal(a[:16]).sum(),
     (X,), "slice: moves the rows away"),
    # a batched solve's right-hand sides split apart from its systems
    ("solve_apart", lambda a, b: torch.linalg.solve(
        a.reshape(N, 4, 4), b[:, :4].sum(0)), (X, X2),
     "_linalg_solve_ex: systems not split along the batch"),
]


@pytest.mark.parametrize("name,fn,operands,reason", _ROW_REJECTS,
                         ids=[r[0] for r in _ROW_REJECTS])
def test_row_partition_rejects(name, fn, operands, reason):
    # rejected with its reason: no other exception leaves the proof
    got = pt.rows(fn, _specs(operands), [0] * len(operands), N)
    assert isinstance(got, str) and got.startswith(reason), got


def _ew_replay(plan, operands, sizes):
    """The plan replayed on the row blocks of ``sizes`` (a broadcast
    operand of one row whole), put back together."""
    outs, lo = [], 0
    for n in sizes:
        blocks = [a if a.shape[0] == 1 else a[lo:lo + n] for a in operands]
        outs.append(plan.run(blocks, (n,) + tuple(plan.out_shape[1:])))
        lo += n
    return torch.cat(outs, 0)


_EW_ACCEPT = [
    ("mul_add", lambda a, b: a * b + 1),
    ("leaky", lambda a, b: torch.where(a > 0, a, 0.5 * a)),
    ("where_sub", lambda a, b: torch.where(a > b, a - b, 0.5 * b)),
    ("scalar_fill", lambda a, b: torch.where(a > b, a, 0.0)),
    ("cast", lambda a, b: (a > b).to(torch.float32) * torch.exp(-b)),
    # a size read from a shape keeps its whole value on every block, as
    # GSPMD's program traced at the whole shapes has it
    ("shape_constant", lambda a, b: a / a.shape[0]),
    ("one_block_differs", lambda a, b: a * (a.shape[0] % 4 == 0)),
    # a pointwise op with two outputs, one read
    ("frexp", lambda a, b: torch.frexp(a).mantissa * b),
]


@pytest.mark.parametrize("name,fn", _EW_ACCEPT, ids=[r[0] for r in _EW_ACCEPT])
@pytest.mark.parametrize("sizes", [(6, 6), (4, 3, 3, 3), (4, 4, 4, 0)],
                         ids=["even", "uneven", "empty"])
def test_elementwise_accepts(name, fn, sizes):
    shape = (12, 8)
    whole = [(shape, torch.float32)] * 2
    plan = pt.elementwise(fn, whole, shape)
    assert not isinstance(plan, str), plan
    assert plan.units >= 1.0
    a = torch.from_numpy(RNG.rand(*shape).astype(np.float32) - 0.5)
    b = torch.from_numpy(RNG.rand(*shape).astype(np.float32))
    assert torch.equal(_ew_replay(plan, (a, b), sizes), fn(a, b))


def test_elementwise_units_count_the_programs_intermediates():
    # where(a > b, a - b, 0.5 * b): the bool mask (a quarter of the
    # float result), the difference and the product live beside the
    # result
    def fn(a, b):
        return torch.where(a > b, a - b, 0.5 * b)

    whole = [((12, 8), torch.float32)] * 2
    assert pt.elementwise(fn, whole, (12, 8)).units == 3.25


def test_elementwise_accepts_the_masked_broadcast():
    # expr/map.py's masked map: the mask (8,) broadcast to the data's
    # (block's) shape. A bool mask's cast is itself and the broadcast a
    # view of it: the program allocates nothing; a block replays the
    # broadcast to its own shape
    def fn(o, m):
        return torch.broadcast_to(m.to(torch.bool), o.shape)

    whole = [((12, 8), torch.float32), ((8,), torch.bool)]
    plan = pt.elementwise(fn, whole, (12, 8))
    assert plan.units == 0.0
    o = torch.zeros(12, 8)
    m = torch.from_numpy(RNG.rand(8) > 0.5)
    got = _ew_replay(plan, (o, m[None]), (6, 6))
    assert torch.equal(got, fn(o, m))


_EW_REJECTS = [
    ("mean", lambda a: a - a.mean(), "not pointwise: mean"),
    ("flip", lambda a: a.flip(0), "not pointwise: flip"),
    ("cumsum", lambda a: torch.cumsum(a, 0), "not pointwise: cumsum"),
    ("rand_like", lambda a: torch.rand_like(a), "random: rand_like"),
    ("item", lambda a: a * a.sum().item(), "trace:"),
    ("to_host", lambda a: torch.from_numpy(a.cpu().numpy()), "trace:"),
    ("in_place", lambda a: a.mul_(2.0), "mul_: writes an operand"),
]


@pytest.mark.parametrize("name,fn,reason", _EW_REJECTS,
                         ids=[r[0] for r in _EW_REJECTS])
def test_elementwise_rejects(name, fn, reason):
    shape = (12, 8)
    got = pt.elementwise(fn, [(shape, torch.float32)], shape)
    assert isinstance(got, str) and got.startswith(reason), got


def _tree(fn, n_in=1):
    return LocalCall(fn, tuple(LocalInput(i) for i in range(n_in)))


@pytest.mark.parametrize("fn,ok", [(lambda a: a * 2.0 + 1.0, True),
                                   (lambda a: a * (a.shape[0] % 4 == 0),
                                    True)],
                         ids=["pointwise", "one_block_differs"])
def test_every_position_takes_the_same_decision(fn, ok):
    # 13 rows over the 4 positions of a 4 x 2 mesh: blocks of 4, 3, 3, 3.
    # The program traced at the whole 13 rows is every block's: a size
    # read from the shape keeps its whole value (13 % 4 != 0 zeroes
    # every block, the 4-row one too)
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.expr.map import _decision

    mesh = mesh_t.build_mesh((4, 2), "cpu")
    xt = torch.from_numpy(RNG.rand(13, 8).astype(np.float32))
    x = st.as_expr(st.from_numpy(xt.numpy()))
    op, t = _tree(fn), Tiling(("x", None))
    pt.clear_cache()
    seen, outs = set(), []
    for i in range(4):
        for j in range(2):
            mesh.coords = {"x": i, "y": j}
            seen.add(proven_elementwise(op, (x,), (13, 8)))
            ext = t.block_extent((13, 8), mesh)
            blk = xt[ext.to_slice()]
            outs.append(_decision(op, (x,), (13, 8)).run([blk], blk.shape))
    assert seen == {ok}
    want = fn(xt)
    assert torch.equal(torch.cat(outs[::2], 0), want)
    assert torch.equal(torch.cat(outs[1::2], 0), want)


def test_each_decision_traces_once_per_key():
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.tiling import Tiling

    mesh = mesh_t.build_mesh((2, 1), "cpu")
    x = st.as_expr(st.from_numpy(RNG.rand(12, 8).astype(np.float32)))
    op = _tree(lambda a: a * 3.0 - 1.0)
    pt.clear_cache()
    n0 = pt.STATS["traces"]
    assert proven_elementwise(op, (x,), (12, 8))
    # the whole shape only: the blocks replay its program
    assert pt.STATS["traces"] - n0 == 1
    for _ in range(3):
        assert proven_elementwise(op, (x,), (12, 8))
    assert pt.STATS["traces"] - n0 == 1
    # a map2: one trace at the whole shapes, then none
    xe = st.as_expr(st.from_numpy(RNG.rand(12, 8).astype(np.float32)))
    we = st.as_expr(st.from_numpy(RNG.rand(8).astype(np.float32),
                                  tiling=Tiling((None,))))
    node = Map2Expr((xe, we), regression._predict_kern)
    tilings = [Tiling(("x", None)), Tiling((None,))]
    n1 = pt.STATS["traces"]
    for _ in range(3):
        plan, row_dims, n_rows, axis = node._row_plan(tilings, mesh)
        assert row_dims == (0, None) and n_rows == 12 and axis == "x"
    assert pt.STATS["traces"] - n1 == 1


def test_card_staging_prices_blocks_not_wholes():
    import spartan_tpu_torch as st
    from spartan_tpu_torch.analysis.plan_audit import dry_mesh
    from spartan_tpu_torch.array.tiling import Tiling

    dm = dry_mesh(mesh_t.build_mesh((2, 1), "cpu"))
    n, d = 1024, 8
    xe = st.as_expr(st.from_numpy(RNG.rand(n, d).astype(np.float32),
                                  tiling=Tiling(("x", None))))
    ye = st.as_expr(st.from_numpy(RNG.rand(n).astype(np.float32),
                                  tiling=Tiling(("x",))))
    we = st.as_expr(st.from_numpy(RNG.rand(d).astype(np.float32),
                                  tiling=Tiling((None,))))
    with mesh_t.use_mesh(dm):
        proven = Map2Expr((xe, ye, we), regression._logistic_kern)
        # the replay on 512 rows a rank: X @ w beside its sigmoid
        assert proven.card_staging(dm) == 2 * (n // 2) * 4
        # a flip along the rows: the reversed block and the moved one,
        # beside the exchange's send and received buffers (every row
        # changes owner), less the output
        flipped = Map2Expr((xe,), lambda a: a.flip(0))
        assert flipped.card_staging(dm) == 3 * (n // 2) * d * 4
        scanned = Map2Expr((xe,), lambda a: a.cumsum(0))
        # not proven: the split operand gathered whole
        assert scanned.card_staging(dm) == n * d * 4
