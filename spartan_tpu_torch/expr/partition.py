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
  memory uninitialised. Then each output element depends on the same
  input elements only, and the program traced at the whole shapes is
  replayed on the aligned blocks (:meth:`ElementwisePlan.run`), each
  size that is a tensor's own whole shape set to its block's, as GSPMD
  runs the program it traced at the whole shapes: a constant such as
  ``/ x.shape[0]`` keeps its whole value.
* **Row-partitionable** (:func:`rows`, a ``map2`` function): the
  program is traced once at the whole shapes (a constant such as
  ``/ x.shape[0]`` is baked in at its whole value) and a state is
  propagated through it: ``R(d)``, split along the row axis at dim d;
  ``W``, whole and the same on every rank; ``P``, a partial sum still
  to be all-reduced; ``S(d)``, a diagonal's elements that lie in the
  rank's rows (each rank holds its own, none twice), which only casts,
  pointwise ops with whole scalars and sums take. A product or sum
  over the rows gives ``P``; a ``P`` that meets an op with no rule for
  it is all-reduced there, as GSPMD does; a mean over the rows is a sum
  all-reduced, then divided by the whole count; a flip along the rows
  is a move of the mirrored rows between the ranks. The accepted
  program is replayed on the rank's blocks (:meth:`RowPlan.run`); the
  function is not called again, since it may compute whole-shape
  constants from its inputs' shapes.

Every decision is taken from shapes and dtypes alone, so every rank of a
group takes the same one, and it is cached by the caller's key (a loop
body traces once a plan). This module imports torch only.
"""

from __future__ import annotations

import operator
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
    """The node's shape; () for a node that is no tensor (a multi-output
    op's tuple, an op that returns nothing)."""
    v = _val(node)
    if not isinstance(v, torch.Tensor):
        return ()
    return tuple(int(s) for s in v.shape)


def _tensors(v: Any) -> List[torch.Tensor]:
    """The tensors of a node's value: itself, a tuple's, or none."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for t in v if isinstance(t, torch.Tensor)]
    return []


def _nbytes(node: Any) -> float:
    return float(sum(_prod(t.shape) * t.element_size()
                     for t in _tensors(_val(node))))


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


def _check_elementwise(gm: torch.fx.GraphModule,
                       out_shape: Tuple[int, ...]) -> Any:
    """The output node of the traced program, once every op is found
    pointwise or value-free and the output one tensor of ``out_shape``;
    raises :class:`Reject` otherwise."""
    out = None
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            if getattr(gm, n.target).numel() > 16:
                raise Reject("constant tensor")
        elif n.op == "call_function":
            _screen(n)
            op = n.target
            if op is operator.getitem:
                continue  # an output of the multi-output op it reads
            if _writes(op) and n.args[0].op != "call_function":
                raise Reject(f"{_name(op)}: writes an operand")
            if op is aten.expand.default:
                if _shape(n) != tuple(out_shape):
                    raise Reject("expand: not to the output's shape")
            elif op is aten.full.default:
                if _shape(n) != ():
                    raise Reject("full: not a scalar")
            elif op not in _VALUE_FREE and \
                    torch.Tag.pointwise not in getattr(op, "tags", ()):
                raise Reject(f"not pointwise: {_name(op)}")
        elif n.op == "output":
            res = n.args[0]
            if not isinstance(res, torch.fx.Node) or \
                    not isinstance(_val(res), torch.Tensor):
                raise Reject("output: not one tensor")
            if _shape(res) != tuple(out_shape):
                raise Reject("output: not the block's shape")
            out = res
        elif n.op != "placeholder":
            raise Reject(f"graph node: {n.op}")
    return out


class ElementwisePlan:
    """A ``map`` tree's program proven elementwise, traced at the whole
    shapes; :meth:`run` replays it on blocks. ``units`` is the most its
    intermediates and result hold at once, in units of the result's
    bytes."""

    def __init__(self, gm: torch.fx.GraphModule, out: Any,
                 out_shape: Tuple[int, ...], units: float):
        self.gm = gm
        self.out = out
        self.out_shape = tuple(out_shape)
        self.units = units

    def _block_shape(self, shape: Sequence[int],
                     out_block: Tuple[int, ...]) -> List[int]:
        """The block of a value of ``shape`` (which broadcasts to the
        output's) aligned with the output block ``out_block``: a
        broadcast dim of 1 stays 1."""
        off = len(self.out_shape) - len(shape)
        return [1 if d == 1 and self.out_shape[i + off] != 1
                else out_block[i + off] for i, d in enumerate(shape)]

    def run(self, blocks: Sequence[torch.Tensor],
            out_block: Sequence[int]) -> torch.Tensor:
        """The program on the aligned ``blocks`` of an output block of
        shape ``out_block``: every size that is a node's own whole shape
        is set to its block's, any other value is the whole-shape
        trace's."""
        out_block = tuple(int(v) for v in out_block)
        device = next((b.device for b in blocks if b.dim()),
                      blocks[0].device if blocks else None)
        env: Dict[Any, Any] = {}
        it = iter(blocks)

        def sized(a: Any, own: Tuple[int, ...], blk: List[int]) -> Any:
            if isinstance(a, (list, tuple)):
                if a and all(isinstance(v, int) for v in a) and \
                        tuple(a) == own:
                    return list(blk)
                return type(a)(sized(v, own, blk) for v in a)
            return a

        for n in self.gm.graph.nodes:
            if n.op == "placeholder":
                env[n] = next(it)
            elif n.op == "get_attr":
                c = getattr(self.gm, n.target)
                env[n] = c.to(device) if c.dim() else c
            elif n.op == "call_function":
                own = _shape(n)
                blk = self._block_shape(own, out_block)
                args = sized(torch.fx.node.map_arg(n.args, lambda a: env[a]),
                             own, blk)
                kwargs = dict(torch.fx.node.map_arg(n.kwargs,
                                                    lambda a: env[a]))
                if "device" in kwargs and device is not None:
                    kwargs["device"] = device
                env[n] = n.target(*args, **kwargs)
        return env[self.out]


def elementwise(fn: Callable, whole: Sequence[Tuple[Tuple[int, ...], Any]],
                out_shape: Tuple[int, ...]) -> Any:
    """An :class:`ElementwisePlan` where ``fn`` over inputs of ``whole``
    (shape, dtype) specs, with a result of ``out_shape``, acts on each
    element alone; otherwise the reason it is not proven (a string). One
    trace, at the whole shapes: a block replays it."""
    try:
        gm = trace(fn, whole)
        out = _check_elementwise(gm, out_shape)
    except Reject as r:
        return r.reason
    steps, _ = _steps(gm)
    out_bytes = _nbytes(out)
    return ElementwisePlan(gm, out, out_shape,
                           _peak(steps, _nbytes) / max(out_bytes, 1.0))


def program_peak(fn: Callable, specs: Sequence[Tuple[Tuple[int, ...], Any]]
                 ) -> float:
    """The most bytes ``fn``'s program over inputs of ``specs`` holds at
    once beside its inputs, its result included (:func:`_peak`). Raises
    :class:`Reject` where ``fn`` does not trace."""
    steps, _ = _steps(trace(fn, specs))
    return _peak(steps, _nbytes)


# -- (b) row-partitionable -----------------------------------------------

W = ("W",)
P = ("P",)


def R(d: int) -> Tuple[str, int]:
    return ("R", d)


def S(d: int) -> Tuple[str, int]:
    return ("S", d)


def _is_r(s: Any) -> bool:
    return s[0] == "R"


def _is_s(s: Any) -> bool:
    return s[0] == "S"


class _Step:
    """One call of the replay: the op, which argument nodes to all-reduce
    first, which size to set to the block's rows, and what the op does
    beyond its own call on a block: ``mean`` (the whole count a mean
    over the rows divides its all-reduced sum by), ``diag`` (+1 or -1: a
    diagonal's offset moved by the block's first row or column) or
    ``move`` (the dim a flip reverses across the ranks)."""

    __slots__ = ("node", "reduce", "rows_at", "frees", "mean", "diag",
                 "move")

    def __init__(self, node: Any):
        self.node = node
        self.reduce: List[Any] = []
        self.rows_at: Optional[Tuple[int, int]] = None  # (arg, position)
        self.frees: List[Any] = []
        self.mean: Optional[int] = None
        self.diag: Optional[int] = None
        self.move: Optional[int] = None


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
        # all-reduce is the caller's), a mean over the rows' among them
        self.inner_reduces = sum(len(s.reduce) + (s.mean is not None)
                                 for s in steps)
        self.moves = [s.node for s in steps if s.move is not None]

    def run(self, blocks: Sequence[torch.Tensor], rows: int,
            reduce: Callable[[torch.Tensor], torch.Tensor],
            start: int = 0,
            move: Optional[Callable[[torch.Tensor, int],
                                    torch.Tensor]] = None) -> torch.Tensor:
        """The program on the rank's operands (``R`` ones cut to its
        ``rows`` rows from row ``start``, ``W`` ones whole); ``reduce``
        all-reduces a partial sum over the row axis; ``move(t, d)`` is
        the rank's block of the array whose blocks along its split dim
        ``d`` the ranks hold reversed (``t``, this rank's reversed):
        each rank's mirrored rows brought to it. Returns the output, a
        partial sum still where ``out_state`` is ``P``."""
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
                if step.mean is not None:
                    env[n] = _mean_replay(args, kwargs, reduce, step.mean)
                elif step.diag is not None:
                    x, off, d1, d2 = _diag_args(args, kwargs)
                    env[n] = torch.diagonal(x, off + step.diag * start, d1,
                                            d2)
                else:
                    env[n] = n.target(*args, **kwargs)
                if step.move is not None:
                    if move is None:
                        raise ValueError("the plan moves rows between the "
                                         "ranks: pass move=")
                    env[n] = move(env[n], step.move)
            for f in step.frees:
                del env[f]
        return env[self.out]

    def card_bytes(self, rows: int,
                   move_bytes: Optional[Callable[[Any], float]] = None
                   ) -> float:
        """The most bytes the replay holds at once at ``rows`` rows a
        block beside its operands (:func:`_peak`), the all-reduces'
        copies included; ``move_bytes(node)`` is what a flip's move
        across the ranks holds beside its two blocks."""
        def block(t: torch.Tensor, s: Any) -> float:
            shp = list(t.shape)
            if _is_r(s):
                shp[s[1]] = rows
            elif _is_s(s):
                # a diagonal's pieces: at most its whole length
                shp[s[1]] = min(shp[s[1]], rows)
            return float(_prod(shp) * t.element_size())

        def nbytes(n: Any) -> float:
            v = _val(n)
            s = self.states.get(n, W)
            if isinstance(v, (list, tuple)):
                ss = s if s and isinstance(s[0], tuple) else [s] * len(v)
                return sum(block(t, x) for t, x in zip(v, ss)
                           if isinstance(t, torch.Tensor))
            return block(v, s) if isinstance(v, torch.Tensor) else 0.0

        def extra(step: _Step) -> float:
            if step.mean is not None:
                return nbytes(step.node)  # the sum beside its all-reduce
            if step.move is not None:
                # the reversed block and the moved one, beside the move's
                # send and received buffers
                return nbytes(step.node) + (
                    move_bytes(step.node) if move_bytes else
                    2.0 * nbytes(step.node))
            return 0.0

        return _peak(self.steps, nbytes, extra)


def _mean_replay(args, kwargs, reduce, count: int) -> torch.Tensor:
    """A mean over the rows on a block, in GSPMD's order: the block's
    sum, all-reduced, divided by the whole count."""
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    dtype = kwargs.get("dtype")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        total = torch.sum(x, dtype=dtype)
        if keep:
            total = total.reshape([1] * x.dim())
    else:
        total = torch.sum(x, list(dims), keepdim=keep, dtype=dtype)
    return reduce(total) / count


def _diag_args(args, kwargs) -> Tuple[Any, int, int, int]:
    """``diagonal``'s (self, offset, dim1, dim2) with their defaults."""
    full = list(args) + [None] * (4 - len(args))
    names = ("self", "offset", "dim1", "dim2")
    vals = [full[i] if full[i] is not None else kwargs.get(k)
            for i, k in enumerate(names)]
    dflt = (None, 0, 0, 1)
    return tuple(v if v is not None else dflt[i]
                 for i, v in enumerate(vals))


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


def _aliases(op: Any) -> bool:
    """True for an op whose result is a view of (or written into) its
    first operand; an output of a multi-output op is a view of its
    tuple."""
    if op is operator.getitem:
        return True
    schema = getattr(op, "_schema", None)
    return bool(schema is not None and schema.returns
                and schema.returns[0].alias_info is not None)


def _peak(steps: Sequence[_Step], nbytes: Callable[[Any], float],
          extra: Optional[Callable[[_Step], float]] = None) -> float:
    """The most bytes a program's new tensors hold at once: each live
    from its call to its last use, a view or an in-place result sharing
    its base's bytes, an all-reduce's copy beside its partial, and what
    ``extra(step)`` says a step holds for its own call; the operands
    cost nothing here. A multi-output op's outputs all live at its
    return; each then lives as the ``getitem`` that reads it, and one
    that nothing reads dies there."""
    base: Dict[Any, Any] = {}
    size: Dict[Any, float] = {}
    aliases: Dict[Any, int] = {}
    live = peak = 0.0
    for step in steps:
        n = step.node
        if n.op == "call_function":
            for r in step.reduce:
                peak = max(peak, live + nbytes(r))
            b = None
            if isinstance(_val(n), (list, tuple)):
                peak = max(peak, live + nbytes(n)
                           + (extra(step) if extra else 0.0))
                for u in n.users:
                    if u.target is operator.getitem and u.users:
                        size[u] = nbytes(u)
                        live += size[u]
            elif n.target is operator.getitem:
                b = n if n in size else None
            elif _aliases(n.target):
                b = base.get(n.args[0])
            else:
                b = n
                size[n] = nbytes(n)
                live += size[n]
            base[n] = b
            if b is not None:
                aliases[b] = aliases.get(b, 0) + 1
            peak = max(peak, live + (extra(step) if extra else 0.0))
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
        if op is operator.getitem:
            # an output of a multi-output op: that output's state
            s = self.s(n.args[0])
            return s[n.args[1]] if isinstance(s[0], tuple) else s
        ins = self.tensors(n)
        states = [self.s(a) for a in ins]
        if _writes(op):
            self.check_inplace(n)
        if not ins:
            return self.factory(n, 0)
        if all(s == W for s in states) and name != "expand":
            # deterministic ops of whole operands: whole on every rank
            # (an expand may split one: ``_expand``)
            if name in ("zeros_like", "new_zeros") or (
                    name in ("full_like", "new_full") and n.args[-1] == 0):
                self.zeros.add(n)
            outs = _val(n)
            if isinstance(outs, (list, tuple)):
                return tuple(W for _ in outs)
            return W
        if any(_is_s(x) for x in states):
            return self.pieces(n, ins, states)
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

    def pieces(self, n: Any, ins: Sequence[Any], states) -> Any:
        """An op of a diagonal's pieces (``S``): a cast keeps them, a
        pointwise op with whole scalars acts on each, a sum over their
        dim is a partial sum; nothing else takes them."""
        op = n.target
        name = _name(op)
        s = next(x for x in states if _is_s(x))
        if op in _VALUE_FREE and len(ins) == 1:
            return s
        if torch.Tag.pointwise in getattr(op, "tags", ()) and all(
                x == s or (x == W and not _shape(a))
                for a, x in zip(ins, states)):
            return S(s[1] + len(_shape(n)) - len(_shape(ins[0])))
        if name == "sum" and len(ins) == 1:
            nd = len(_shape(ins[0]))
            dims = n.args[1] if len(n.args) > 1 else None
            if dims is None or (isinstance(dims, (list, tuple))
                                and not dims):
                return P
            dims = [dims] if isinstance(dims, int) else list(dims)
            dims = [_norm_dim(int(v), nd) for v in dims]
            if s[1] in dims:
                return P
            keep = n.args[2] if len(n.args) > 2 else \
                n.kwargs.get("keepdim", False)
            return S(s[1] if keep else
                     s[1] - sum(1 for v in dims if v < s[1]))
        raise Reject(f"{name}: of a diagonal's pieces")

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
        if name in ("scalar_tensor", "arange", "eye"):
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
    """True for an op that writes its first operand (in place); an op
    with no schema (``operator.getitem``) writes nothing."""
    schema = getattr(op, "_schema", None)
    if schema is None:
        return False
    args = schema.arguments
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
        # the dims before and after the rows may merge or split among
        # themselves; the rows stay one dim of the same extent
        if _prod(shp_out[:e]) == _prod(shp_in[:d]) and \
                shp_out[e] == shp_in[d] and \
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
    """An expand of a split operand keeps its rows (a size of the whole
    row count set to the block's); a whole operand expanded to the
    whole row count along a dim of 1 (or a new one) is split there, cut
    to the block's rows: it is the same along that dim."""
    x = n.args[0]
    s = w.s(x)
    if s == W and w.n > 1:
        size, shp = list(n.args[1]), _shape(x)
        off = len(size) - len(shp)
        hits = [j for j, v in enumerate(size)
                if v == w.n and (j < off or shp[j - off] == 1)]
        if len(hits) == 1:
            w.step.rows_at = (1, hits[0])
            return R(hits[0])
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


def _mean(w: _Rows, n: Any) -> Any:
    """``mean``: along other dims than the rows the rows stay split;
    over the rows it is GSPMD's reduce-sum, all-reduce, divide: the
    block's sum all-reduced in the step, then divided by the whole
    count (whole on every rank)."""
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return _along(w, n)
    nd = len(_shape(x))
    dims = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        dims = list(range(nd))
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [_norm_dim(int(v), nd) for v in dims]
    if s[1] not in dims:
        return _along(w, n)
    shp = _shape(x)
    w.step.mean = _prod(shp[v] for v in dims)
    return W


def _diagonal(w: _Rows, n: Any) -> Any:
    """``diagonal`` of an operand split along one of its two dims: the
    elements in the rank's rows (its offset moved by the block's first
    row, or back by its first column), a piece of the whole (``S``);
    split along another dim, the rows stay split."""
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    if not _is_r(s):
        raise Reject("diagonal: of a diagonal's pieces")
    nd = len(_shape(x))
    _, _, d1, d2 = _diag_args(n.args, n.kwargs)
    d1, d2 = _norm_dim(int(d1), nd), _norm_dim(int(d2), nd)
    d = s[1]
    if d not in (d1, d2):
        return R(d - sum(1 for v in (d1, d2) if v < d))
    w.step.diag = 1 if d == d1 else -1
    return S(nd - 2)  # the diagonal is the last dim


def _flip(w: _Rows, n: Any) -> Any:
    """``flip``: along other dims the block flips alone; along the rows
    each rank's output rows are the mirrored rows another rank holds,
    brought by a move between the ranks (GSPMD's collective-permute)."""
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    if not _is_r(s):
        raise Reject("flip: of a diagonal's pieces")
    nd = len(_shape(x))
    if s[1] in [_norm_dim(int(v), nd) for v in n.args[1]]:
        w.step.move = s[1]
    return s


def _cumsum(w: _Rows, n: Any) -> Any:
    """``cumsum`` along another dim than the rows: each row's scan is the
    block's (a partial scanned is still partial); along the rows it has
    no rule (GSPMD gathers it too)."""
    x = n.args[0]
    s = w.s(x)
    if s in (W, P):
        return s
    if not _is_r(s):
        raise Reject("cumsum: of a diagonal's pieces")
    if _norm_dim(int(n.args[1]), len(_shape(x))) == s[1]:
        raise Reject("cumsum: along the rows")
    return s


def _solve(w: _Rows, n: Any) -> Any:
    """A batched ``linalg.solve``: systems split along their batch dim
    (0) are solved on each rank; every output keeps the split."""
    a, b = n.args[:2]
    if w.s(a) == R(0) and w.s(b) == R(0) and len(_shape(a)) >= 3:
        return tuple(R(0) for _ in _val(n))
    raise Reject(f"{_name(n.target)}: systems not split along the batch")


def _check_errors(w: _Rows, n: Any) -> Any:
    """``_linalg_check_errors`` of a solve's status: each rank checks
    its own systems; it returns nothing."""
    if _is_r(w.s(n.args[0])):
        return W
    raise Reject("_linalg_check_errors: of a partial")


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
    "mean": _mean,
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
    "diagonal": _diagonal,
    "flip": _flip,
    "cumsum": _cumsum,
    "_linalg_solve_ex": _solve,
    "linalg_solve_ex": _solve,
    "_linalg_check_errors": _check_errors,
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
    if not isinstance(_val(out), torch.Tensor):
        raise Reject("output: not one tensor")
    if _is_s(w.st[out]):
        raise Reject("output: a diagonal's pieces")
    return RowPlan(gm, w.st, steps, out, n_rows)
