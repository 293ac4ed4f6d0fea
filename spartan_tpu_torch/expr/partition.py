"""Which user functions may run on a rank's blocks: a proof from the aten
ops a function traces to.

On a group mesh the JAX package's ``map`` and ``map2`` hand their
function sharded arrays, and GSPMD partitions the ops it traces,
inserting only the collectives the data flow needs. The port sees the
same ops: it captures the function's aten program on ``meta`` tensors
(``torch.fx.experimental.proxy_tensor.make_fx``; shapes and dtypes, no
data) and runs the function on blocks only where that program proves it
right. Everything else keeps the counted gather.

* **Elementwise** (:func:`elementwise`, a ``map`` tree): every op is
  pointwise (``torch.Tag.pointwise``) or one of a few value-free ops
  (casts, copies, a constant, a broadcast to the output's own shape);
  nothing reads a value to the host, draws a random number or leaves
  memory uninitialised; and the program traced at the whole shapes is
  the one traced at every distinct block shape of the mesh, argument for
  argument, apart from sizes that follow the tensors' own shapes. Then
  each output element depends on the same input elements only, and the
  tree runs on the aligned blocks.
* **Row-partitionable** (:func:`rows`, a ``map2`` function): the
  program is traced once at the whole shapes (a constant such as
  ``/ x.shape[0]`` is baked in at its whole value) and a state is
  propagated through it: ``R(d)``, split along the row axis at dim d;
  ``W``, whole and the same on every rank; ``P``, a partial sum still
  to be all-reduced. A product or sum over the rows gives ``P``; a
  ``P`` that meets an op with no rule for it is all-reduced there, as
  GSPMD does. The accepted program is replayed on the rank's blocks
  (:meth:`RowPlan.run`); the function is not called again, since it
  may compute whole-shape constants from its inputs' shapes.

Every decision is taken from shapes and dtypes alone, so every rank of a
group takes the same one, and it is cached by the caller's key (a loop
body traces once a plan). This module imports torch only.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

aten = torch.ops.aten

# decisions by the caller's key, and the count of traces taken
_CACHE: Dict[Any, Any] = {}
_CACHE_MAX = 4096
_LOCK = threading.RLock()
STATS = {"traces": 0}

# ops that carry no value of their own beside a pointwise program: casts,
# copies, constants and shape-following fills
_VALUE_FREE = {
    aten._to_copy.default, aten.clone.default, aten.detach.default,
    aten.alias.default, aten.lift_fresh_copy.default,
    aten.scalar_tensor.default, aten.zeros_like.default,
    aten.ones_like.default, aten.full_like.default,
}
_UNINITIALISED = {"empty", "empty_like", "new_empty", "empty_strided",
                  "new_empty_strided", "empty_permuted"}
_HOST_READS = {"_local_scalar_dense", "item"}


class Reject(Exception):
    """The function is not proven; ``reason`` names why."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def clear_cache() -> None:
    """Drop every cached decision (tests)."""
    with _LOCK:
        _CACHE.clear()


def trace(fn: Callable, specs: Sequence[Tuple[Tuple[int, ...], Any]]
          ) -> torch.fx.GraphModule:
    """``fn``'s aten program over ``meta`` tensors of ``specs`` (shape,
    torch dtype) pairs. Raises :class:`Reject` where it cannot be
    traced (a host read, a data-dependent branch, a copy to another
    device)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    args = [torch.empty(tuple(s), dtype=dt, device="meta")
            for s, dt in specs]
    with _LOCK:
        STATS["traces"] += 1
        try:
            with torch.no_grad():
                return make_fx(lambda *xs: fn(*xs))(*args)
        except Exception as e:  # noqa: BLE001 - any failure is a rejection
            raise Reject(f"trace: {type(e).__name__}") from None


def _name(op: Any) -> str:
    return getattr(op, "__name__", str(op)).split(".")[0]


def _val(node: Any) -> Any:
    return node.meta.get("val") if hasattr(node, "meta") else None


def _shape(node: Any) -> Tuple[int, ...]:
    v = _val(node)
    return tuple(int(s) for s in v.shape)


def _screen(node: Any) -> None:
    """Reject ops that read a value to the host, draw random numbers or
    leave memory uninitialised."""
    op = node.target
    name = _name(op)
    if name in _HOST_READS:
        raise Reject(f"host read: {name}")
    if torch.Tag.nondeterministic_seeded in getattr(op, "tags", ()):
        raise Reject(f"random: {name}")
    if name in _UNINITIALISED:
        raise Reject(f"uninitialised: {name}")


def cached(key: Any, decide: Callable[[], Any]) -> Any:
    """The decision under ``key``, taken once by ``decide()``."""
    with _LOCK:
        if key in _CACHE:
            return _CACHE[key]
        hit = decide()
        if len(_CACHE) < _CACHE_MAX:
            _CACHE[key] = hit
        return hit


# -- (a) elementwise ------------------------------------------------------


def _program(gm: torch.fx.GraphModule, out_shape: Tuple[int, ...]
             ) -> Tuple:
    """The traced program as comparable data: each op and its non-tensor
    arguments, a tensor argument by its position, and a size that is
    the node's own output shape as ``<shape>``. Raises :class:`Reject`
    for an op that is not pointwise or value-free, or an output that is
    not one tensor of ``out_shape``."""
    pos: Dict[Any, int] = {}
    prog: List[Any] = []

    def norm(a: Any, own: Tuple[int, ...]) -> Any:
        if isinstance(a, torch.fx.Node):
            return ("%", pos[a])
        if isinstance(a, (list, tuple)):
            if a and all(isinstance(v, int) for v in a) and \
                    tuple(a) == own:
                return "<shape>"
            return tuple(norm(v, own) for v in a)
        if isinstance(a, torch.device):
            return "<device>"
        return a

    for i, n in enumerate(gm.graph.nodes):
        pos[n] = i
        if n.op == "placeholder":
            prog.append(("in",))
        elif n.op == "get_attr":
            c = getattr(gm, n.target)
            if c.numel() > 16:
                raise Reject("constant tensor")
            prog.append(("const", str(c.dtype), tuple(c.shape),
                         tuple(c.reshape(-1).tolist())))
        elif n.op == "call_function":
            _screen(n)
            op = n.target
            own = _shape(n)
            if _writes(op) and n.args[0].op != "call_function":
                raise Reject(f"{_name(op)}: writes an operand")
            if op is aten.expand.default:
                if own != tuple(out_shape):
                    raise Reject("expand: not to the output's shape")
            elif op is aten.full.default:
                if own != ():
                    raise Reject("full: not a scalar")
            elif op not in _VALUE_FREE and \
                    torch.Tag.pointwise not in getattr(op, "tags", ()):
                raise Reject(f"not pointwise: {_name(op)}")
            prog.append((str(op), norm(n.args, own),
                         tuple(sorted((k, norm(v, own))
                                      for k, v in n.kwargs.items()))))
        elif n.op == "output":
            res = n.args[0]
            if not isinstance(res, torch.fx.Node):
                raise Reject("output: not one tensor")
            if _shape(res) != tuple(out_shape):
                raise Reject("output: not the block's shape")
            prog.append(("out", pos[res]))
        else:
            raise Reject(f"graph node: {n.op}")
    return tuple(prog)


def elementwise(fn: Callable, whole: Sequence[Tuple[Tuple[int, ...], Any]],
                out_shape: Tuple[int, ...],
                blocks: Sequence[Tuple[Sequence[Tuple[int, ...]],
                                       Tuple[int, ...]]]
                ) -> Tuple[Optional[str], float]:
    """(None, units) where ``fn`` over inputs of ``whole`` (shape, dtype)
    specs, with a result of ``out_shape``, acts on each element alone
    and the same way at every block shape: ``blocks`` holds each
    distinct (input block shapes, output block shape) of the mesh;
    ``units`` is the most its intermediates and result hold at once, in
    units of the result's bytes. Otherwise (the reason it is not
    proven, 0)."""
    try:
        gm = trace(fn, whole)
        want = _program(gm, out_shape)
        for shapes, out_blk in blocks:
            specs = [(s, dt) for s, (_, dt) in zip(shapes, whole)]
            if _program(trace(fn, specs), out_blk) != want:
                raise Reject("program differs at a block's shape")
    except Reject as r:
        return r.reason, 0.0
    steps, out = _steps(gm)
    v = _val(out)
    out_bytes = float(_prod(v.shape) * v.element_size())
    return None, _peak(steps, lambda n: float(
        _prod(_val(n).shape) * _val(n).element_size())) / max(out_bytes, 1.0)


# -- (b) row-partitionable -----------------------------------------------

W = ("W",)
P = ("P",)


def R(d: int) -> Tuple[str, int]:
    return ("R", d)


def _is_r(s: Any) -> bool:
    return s[0] == "R"


class _Step:
    """One call of the replay: the op, which argument nodes to all-reduce
    first, and which size to set to the block's rows."""

    __slots__ = ("node", "reduce", "rows_at", "frees")

    def __init__(self, node: Any):
        self.node = node
        self.reduce: List[Any] = []
        self.rows_at: Optional[Tuple[int, int]] = None  # (arg, position)
        self.frees: List[Any] = []


class RowPlan:
    """An accepted ``map2`` program: the traced graph with each node's
    state, the all-reduces inserted where a partial sum meets an op that
    needs it whole, and the sizes rewritten to the block's rows."""

    def __init__(self, gm: torch.fx.GraphModule, states: Dict[Any, Any],
                 steps: List[_Step], out: Any, n_rows: int):
        self.gm = gm
        self.states = states
        self.steps = steps
        self.out = out
        self.n_rows = n_rows
        self.out_state = states[out]
        # partial sums all-reduced inside the program (the output's own
        # all-reduce is the caller's)
        self.inner_reduces = sum(len(s.reduce) for s in steps)

    def run(self, blocks: Sequence[torch.Tensor], rows: int,
            reduce: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The program on the rank's operands (``R`` ones cut to its
        ``rows`` rows, ``W`` ones whole); ``reduce`` all-reduces a
        partial sum over the row axis. Returns the output, a partial sum
        still where ``out_state`` is ``P``."""
        env: Dict[Any, Any] = {}
        # the fills' device: the operands' (a scalar operand may be a
        # host tensor)
        device = next((b.device for b in blocks if b.dim()),
                      blocks[0].device if blocks else None)
        it = iter(blocks)
        for step in self.steps:
            n = step.node
            if n.op == "placeholder":
                env[n] = next(it)
            elif n.op == "get_attr":
                env[n] = getattr(self.gm, n.target)
            else:
                for r in step.reduce:
                    env[r] = reduce(env[r])
                args = torch.fx.node.map_arg(n.args, lambda a: env[a])
                kwargs = dict(torch.fx.node.map_arg(n.kwargs,
                                                    lambda a: env[a]))
                if step.rows_at is not None:
                    i, j = step.rows_at
                    args = list(args)
                    size = list(args[i])
                    size[j] = rows
                    args[i] = size
                if "device" in kwargs and device is not None:
                    kwargs["device"] = device
                env[n] = n.target(*args, **kwargs)
            for f in step.frees:
                del env[f]
        return env[self.out]

    def card_bytes(self, rows: int) -> float:
        """The most bytes the replay holds at once at ``rows`` rows a
        block beside its operands (:func:`_peak`), the all-reduces'
        copies included."""
        def nbytes(n: Any) -> float:
            v = _val(n)
            shp = list(v.shape)
            s = self.states.get(n, W)
            if _is_r(s):
                shp[s[1]] = rows
            return float(_prod(shp) * v.element_size())

        return _peak(self.steps, nbytes)


def _steps(gm: torch.fx.GraphModule) -> Tuple[List[_Step], Any]:
    """The graph's nodes as steps, each freeing the values it reads last
    (the output kept), and the output node."""
    nodes = [n for n in gm.graph.nodes if n.op != "output"]
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    steps = [_Step(n) for n in nodes]
    at = {s.node: s for s in steps}
    last: Dict[Any, Any] = {}
    for n in nodes:
        for a in n.all_input_nodes:
            last[a] = n
    for a, user in last.items():
        if a is not out:
            at[user].frees.append(a)
    return steps, out


def _peak(steps: Sequence[_Step], nbytes: Callable[[Any], float]) -> float:
    """The most bytes a program's new tensors hold at once: each live
    from its call to its last use, a view or an in-place result sharing
    its base's bytes, an all-reduce's copy beside its partial; the
    operands cost nothing here."""
    base: Dict[Any, Any] = {}
    size: Dict[Any, float] = {}
    aliases: Dict[Any, int] = {}
    live = peak = 0.0
    for step in steps:
        n = step.node
        if n.op == "call_function":
            for r in step.reduce:
                peak = max(peak, live + nbytes(r))
            op = n.target
            if op._schema.returns and \
                    op._schema.returns[0].alias_info is not None:
                b = base.get(n.args[0])
            else:
                b = n
                size[n] = nbytes(n)
                live += size[n]
            base[n] = b
            if b is not None:
                aliases[b] = aliases.get(b, 0) + 1
            peak = max(peak, live)
        for f in step.frees:
            b = base.get(f)
            if b is None:
                continue
            aliases[b] -= 1
            if aliases[b] == 0:
                live -= size[b]
    return peak


def _norm_dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


class _Rows:
    """The state walk over one traced ``map2`` program."""

    def __init__(self, gm: torch.fx.GraphModule, row_dims, n_rows: int):
        self.gm = gm
        self.row_dims = list(row_dims)
        self.n = int(n_rows)
        self.st: Dict[Any, Any] = {}
        self.order: Dict[Any, int] = {}
        self.zeros: set = set()  # zero-filled W factories
        self.step: Optional[_Step] = None

    # -- helpers --------------------------------------------------------

    def s(self, a: Any) -> Any:
        return self.st[a] if isinstance(a, torch.fx.Node) else W

    def need_whole(self, nodes: Sequence[Any]) -> None:
        """All-reduce every partial among ``nodes`` before this op: from
        here on each is whole (W)."""
        for a in nodes:
            if isinstance(a, torch.fx.Node) and self.st[a] == P:
                self.step.reduce.append(a)
                self.st[a] = W

    def tensors(self, n: Any) -> List[Any]:
        return [a for a in n.all_input_nodes]

    def rows_size(self, n: Any, i: int) -> Any:
        """A factory's or a reshape's size argument ``i`` with at most one
        dim of the whole row count: R(that dim), rewritten to the block's
        rows, or W."""
        size = list(n.args[i])
        hits = [j for j, v in enumerate(size) if v == self.n]
        if not hits:
            return W
        if len(hits) > 1:
            raise Reject(f"{_name(n.target)}: rows in two dims")
        self.step.rows_at = (i, hits[0])
        return R(hits[0])

    # -- the rules ------------------------------------------------------

    def pointwise(self, n: Any) -> Any:
        ins = self.tensors(n)
        states = [self.s(a) for a in ins]
        if P in states:
            name = _name(n.target)
            others = [x for x in states if x != P]
            if name in ("add", "sub") and not others and \
                    not _scalar_args(n):
                return P
            if name in ("neg",) and len(states) == 1:
                return P
            if name in ("mul", "div") and states.count(P) == 1 and \
                    all(x == W for x in others) and \
                    (name == "mul" or self.s(n.args[0]) == P):
                return P
            self.need_whole(ins)
            states = [self.s(a) for a in ins]
        return self.broadcast(n, ins, states)

    def broadcast(self, n: Any, ins: Sequence[Any], states) -> Any:
        out_nd = len(_shape(n))
        dims = set()
        for a, s in zip(ins, states):
            if _is_r(s):
                dims.add(s[1] + out_nd - len(_shape(a)))
        if not dims:
            return W
        if len(dims) > 1:
            raise Reject(f"{_name(n.target)}: rows on two dims")
        d = dims.pop()
        for a, s in zip(ins, states):
            if s == W:
                shp = _shape(a)
                j = d - (out_nd - len(shp))
                if j >= 0 and shp[j] != 1:
                    raise Reject(f"{_name(n.target)}: a whole operand "
                                 "spans the rows")
        return R(d)

    def passthrough(self, n: Any) -> Any:
        x = n.args[0]
        s = self.s(x)
        if s == P and n.target is aten._to_copy.default and \
                n.kwargs.get("dtype", _val(x).dtype) != _val(x).dtype:
            self.need_whole([x])
            return W
        return s

    def call(self, n: Any) -> Any:
        op = n.target
        name = _name(op)
        _screen(n)
        ins = self.tensors(n)
        states = [self.s(a) for a in ins]
        if _writes(op):
            self.check_inplace(n)
        if not ins:
            return self.factory(n, 0)
        if all(s == W for s in states):
            # deterministic ops of whole operands: whole on every rank
            if name in ("zeros_like", "new_zeros") or (
                    name in ("full_like", "new_full") and n.args[-1] == 0):
                self.zeros.add(n)
            return W
        if name in ("index_add", "index_add_", "scatter_add",
                    "scatter_add_"):
            return self.scatter(n)
        if name in ("new_zeros", "new_ones", "new_full"):
            return self.factory(n, 1)
        if name in ("zeros_like", "ones_like", "full_like"):
            x = self.s(n.args[0])
            return W if x == P else x
        if op in _VALUE_FREE:
            return self.passthrough(n)
        if torch.Tag.pointwise in getattr(op, "tags", ()):
            return self.pointwise(n)
        rule = _RULES.get(name)
        if rule is None:
            raise Reject(f"no rule: {name}")
        return rule(self, n)

    def check_inplace(self, n: Any) -> None:
        """An op that writes its first operand: not an operand or a
        constant, and read by nothing after it."""
        x = n.args[0]
        if x.op != "call_function":
            raise Reject(f"{_name(n.target)}: writes an operand")
        me = self.order[n]
        if any(self.order[u] > me for u in x.users if u is not n):
            raise Reject(f"{_name(n.target)}: its operand is read after")

    def factory(self, n: Any, i: int) -> Any:
        """A fill of the size at argument ``i``: of the whole row count
        along one dim, rows (its size rewritten to the block's); else
        whole."""
        name = _name(n.target)
        if name in ("zeros", "ones", "full", "new_zeros", "new_ones",
                    "new_full"):
            s = self.rows_size(n, i)
            if s == W and (name.endswith("zeros") or (
                    name.endswith("full") and n.args[i + 1] == 0)):
                self.zeros.add(n)
            return s
        if name in ("scalar_tensor", "arange"):
            # the same values on every rank (an arange of the rows is
            # whole too: used against split rows it is rejected where
            # it meets them)
            return W
        raise Reject(f"no rule: {name}")

    def scatter(self, n: Any) -> Any:
        """``index_add``/``scatter_add`` of row-split sources into a
        zero-filled whole target: each rank adds its rows, a partial
        sum."""
        tgt, dim, index, src = n.args[:4]
        if tgt not in self.zeros or self.s(tgt) != W:
            raise Reject(f"{_name(n.target)}: the target is not zeros")
        si, ss = self.s(index), self.s(src)
        if ss == W and si == W:
            return W
        d = _norm_dim(int(dim), len(_shape(src)))
        name = _name(n.target)
        if name.startswith("index_add"):
            ok = si == R(0) and ss == R(d)
        else:
            ok = si == R(d) and ss == R(d)
        if not ok:
            raise Reject(f"{name}: sources not split along its dim")
        return P


def _segment_block(w: _Rows, n: Any) -> Any:
    """The block segment-sum kernel (``kernels/segment.py``'s operator):
    values and ids split along the rows give each rank the sum of its
    rows' entries into the same buckets, a partial sum."""
    vals, ids = n.args[0], n.args[1]
    if w.s(vals) == R(0) and w.s(ids) == R(0):
        return P
    raise Reject("segment_sum_block: entries not split along the rows")


def _writes(op: Any) -> bool:
    """True for an op that writes its first operand (in place)."""
    args = op._schema.arguments
    return bool(args) and args[0].alias_info is not None and \
        args[0].alias_info.is_write


def _scalar_args(n: Any) -> bool:
    return any(isinstance(a, (int, float, bool)) for a in n.args)


def _r_dim_move(new_dim: Callable[[_Rows, Any, int], Optional[int]]):
    """A view's rule: a whole or partial operand stays so; a split one
    keeps its rows at the dim ``new_dim`` gives (None rejects)."""
    def rule(w: _Rows, n: Any) -> Any:
        s = w.s(n.args[0])
        if s in (W, P):
            return s
        d = new_dim(w, n, s[1])
        if d is None:
            raise Reject(f"{_name(n.target)}: moves the rows away")
        return R(d)

    return rule


def _permute(w, n, d):
    dims = [_norm_dim(int(v), len(n.args[1])) for v in n.args[1]]
    return dims.index(d)


def _t(w, n, d):
    return 1 - d if len(_shape(n.args[0])) == 2 else d


def _transpose(w, n, d):
    nd = len(_shape(n.args[0]))
    a, b = _norm_dim(int(n.args[1]), nd), _norm_dim(int(n.args[2]), nd)
    return b if d == a else a if d == b else d


def _unsqueeze(w, n, d):
    dim = _norm_dim(int(n.args[1]), len(_shape(n)))
    return d + 1 if dim <= d else d


def _squeeze(w, n, d):
    nd = len(_shape(n.args[0]))
    dims = n.args[1] if len(n.args) > 1 else None
    if dims is None:
        return None
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [_norm_dim(int(v), nd) for v in dims]
    if d in dims:
        return None
    return d - sum(1 for v in dims if v < d and _shape(n.args[0])[v] == 1)


def _select(w, n, d):
    dim = _norm_dim(int(n.args[1]), len(_shape(n.args[0])))
    if dim == d:
        return None
    return d - 1 if dim < d else d


def _slice(w, n, d):
    x = n.args[0]
    dim = _norm_dim(int(n.args[1]) if len(n.args) > 1 else 0,
                    len(_shape(x)))
    if dim != d:
        return d
    start = n.args[2] if len(n.args) > 2 else None
    end = n.args[3] if len(n.args) > 3 else None
    step = n.args[4] if len(n.args) > 4 else 1
    if start in (None, 0) and (end is None or end >= w.n) and step == 1:
        return d
    return None


def _view(w: _Rows, n: Any) -> Any:
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    d = s[1]
    shp_in, shp_out = _shape(x), _shape(n)
    for e in range(len(shp_out)):
        if shp_out[:e] == shp_in[:d] and shp_out[e] == shp_in[d] and \
                _prod(shp_out[e + 1:]) == _prod(shp_in[d + 1:]):
            size = list(n.args[1])
            if size[e] not in (-1, w.n):
                break
            # every other -1 resolved, the rows the block's
            size = [v if v != -1 else shp_out[j] for j, v in enumerate(size)]
            args = list(n.args)
            args[1] = size
            n.args = tuple(args)
            w.step.rows_at = (1, e)
            return R(e)
    raise Reject(f"{_name(n.target)}: reshapes the rows")


def _prod(xs) -> int:
    k = 1
    for v in xs:
        k *= int(v)
    return k


def _expand(w: _Rows, n: Any) -> Any:
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    size = list(n.args[1])
    e = s[1] + len(size) - len(_shape(x))
    if size[e] not in (-1, w.n):
        raise Reject("expand: of the rows")
    if size[e] == w.n:
        w.step.rows_at = (1, e)
    return R(e)


def _cat(w: _Rows, n: Any) -> Any:
    parts = list(n.args[0])
    nd = len(_shape(n))
    stack = _name(n.target) == "stack"
    dim = _norm_dim(int(n.args[1]) if len(n.args) > 1 else 0, nd)
    states = [w.s(a) for a in parts]
    if all(s == P for s in states):
        return P
    if P in states:
        w.need_whole(parts)
        states = [w.s(a) for a in parts]
    if all(s == W for s in states):
        return W
    if not all(_is_r(s) for s in states) or len(set(states)) != 1:
        raise Reject(f"{_name(n.target)}: of split and whole parts")
    d = states[0][1]
    if stack:
        d = d + 1 if dim <= d else d
    elif dim == d:
        raise Reject(f"{_name(n.target)}: along the rows")
    return R(d)


def _sum(w: _Rows, n: Any) -> Any:
    """``sum``: over the rows a partial sum; along other dims the rows
    stay split; a partial summed is still partial."""
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    nd = len(_shape(x))
    dims = n.args[1] if len(n.args) > 1 else None
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return P
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [_norm_dim(int(v), nd) for v in dims]
    d = s[1]
    if d in dims:
        return P
    keep = n.args[2] if len(n.args) > 2 else n.kwargs.get("keepdim", False)
    return R(d if keep else d - sum(1 for v in dims if v < d))


def _along(w: _Rows, n: Any) -> Any:
    """A reduction or a normalisation along other dims than the rows:
    the rows stay split (over the rows it has no rule)."""
    x = n.args[0]
    s = w.s(x)
    if s == P:
        w.need_whole([x])
        return W
    if s == W:
        return W
    nd = len(_shape(x))
    dims = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        raise Reject(f"{_name(n.target)}: over every dim")
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [_norm_dim(int(v), nd) for v in dims]
    d = s[1]
    if d in dims:
        raise Reject(f"{_name(n.target)}: over the rows")
    if len(_shape(n)) == nd:
        return R(d)
    return R(d - sum(1 for v in dims if v < d))


# per product: the contracted dim of each operand, the kept dims of each
# (operand dim -> output dim), and a batch dim both share
_PRODUCTS = {"mm": (1, 0, {0: 0}, {1: 1}, None),
             "mv": (1, 0, {0: 0}, {}, None),
             "dot": (0, 0, {}, {}, None),
             "bmm": (2, 1, {1: 1}, {2: 2}, 0)}


def _matmul(w: _Rows, n: Any) -> Any:
    """``mm``/``mv``/``dot``/``bmm``: a split operand whose row dim
    survives gives rows; both operands split along the contraction give
    a partial sum; a partial times a whole operand stays partial."""
    return _product(w, _name(n.target), n.args[0], n.args[1])


def _product(w: _Rows, name: str, a: Any, b: Any) -> Any:
    sa, sb = w.s(a), w.s(b)
    if P in (sa, sb):
        if W in (sa, sb):
            return P
        w.need_whole([a, b])
        sa, sb = w.s(a), w.s(b)
    if sa == W and sb == W:
        return W
    ka, kb, keep_a, keep_b, batch = _PRODUCTS[name]
    if sa == R(ka) and sb == R(kb):
        return P
    if batch is not None and sa == R(batch) and sb == R(batch):
        return R(batch)
    if _is_r(sa) and sb == W and sa[1] in keep_a:
        return R(keep_a[sa[1]])
    if sa == W and _is_r(sb) and sb[1] in keep_b:
        return R(keep_b[sb[1]])
    raise Reject(f"{name}: operands split apart")


def _addmm(w: _Rows, n: Any) -> Any:
    """``bias + a @ b``: the product's state, then the bias added as a
    pointwise operand (never to a partial sum)."""
    bias, a, b = n.args[:3]
    w.need_whole([bias, a, b])
    prod = _product(w, "mm", a, b)
    if prod == P:
        raise Reject("addmm: a bias added to a partial sum")
    # the product has the output's shape: ``n`` stands for it
    return w.broadcast(n, [bias, n], [w.s(bias), prod])


_RULES: Dict[str, Callable[[_Rows, Any], Any]] = {
    "permute": _r_dim_move(_permute),
    "t": _r_dim_move(_t),
    "transpose": _r_dim_move(_transpose),
    "unsqueeze": _r_dim_move(_unsqueeze),
    "unsqueeze_": _r_dim_move(_unsqueeze),
    "squeeze": _r_dim_move(_squeeze),
    "squeeze_": _r_dim_move(_squeeze),
    "select": _r_dim_move(_select),
    "slice": _r_dim_move(_slice),
    "view": _view,
    "_unsafe_view": _view,
    "reshape": _view,
    "expand": _expand,
    "cat": _cat,
    "stack": _cat,
    "sum": _sum,
    "mean": _along,
    "amax": _along,
    "amin": _along,
    "argmax": _along,
    "argmin": _along,
    "prod": _along,
    "any": _along,
    "all": _along,
    "logsumexp": _along,
    "_softmax": _along,
    "_log_softmax": _along,
    "mm": _matmul,
    "mv": _matmul,
    "dot": _matmul,
    "bmm": _matmul,
    "addmm": _addmm,
    "segment_sum_block": _segment_block,
}


def rows(fn: Callable, specs: Sequence[Tuple[Tuple[int, ...], Any]],
         row_dims: Sequence[Optional[int]], n_rows: int):
    """A :class:`RowPlan` of ``fn`` over inputs of ``specs`` (whole
    shape, dtype), ``row_dims[i]`` the split dim of input i (0) or None
    for an input every rank holds whole, ``n_rows`` the whole row count;
    or the reason it is not proven (a string)."""
    try:
        gm = trace(fn, specs)
        return _walk(gm, row_dims, n_rows)
    except Reject as r:
        return r.reason


def _walk(gm: torch.fx.GraphModule, row_dims, n_rows: int) -> RowPlan:
    w = _Rows(gm, row_dims, n_rows)
    for i, n in enumerate(gm.graph.nodes):
        w.order[n] = i
    steps, out = _steps(gm)
    if not isinstance(out, torch.fx.Node):
        raise Reject("output: not one tensor")
    k = 0
    for step in steps:
        n = step.node
        w.step = step
        if n.op == "placeholder":
            d = w.row_dims[k]
            k += 1
            w.st[n] = W if d is None else R(d)
        elif n.op == "get_attr":
            w.st[n] = W
        elif n.op == "call_function":
            w.st[n] = w.call(n)
        else:
            raise Reject(f"graph node: {n.op}")
    return RowPlan(gm, w.st, steps, out, n_rows)
