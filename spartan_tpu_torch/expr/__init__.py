"""Public lazy-expression API (the slice of ``spartan_tpu.expr`` this
package carries)."""

from .base import (DictExpr, Expr, ListExpr, ScalarExpr, TupleExpr, ValExpr,
                   as_expr, clear_plan_cache, dict_of, evaluate, lazify,
                   plan_cache_size, plan_stats, reset_plan_stats, tuple_of)
from .builtins import *  # noqa: F401,F403
from .builtins import __all__ as _builtin_all
from .assign import WriteExpr, assign, write_array
from .dot import DotExpr, DotShardMapExpr, dot, dot_shardmap
from .filter import GatherExpr, filter
from .fio import from_file, load, save
from .loop import LoopExpr, LoopItemExpr, loop
from .map import MapExpr, MapWithLocationExpr, map, map_with_location
from .map2 import Map2Expr, ShardMap2Expr, map2, shard_map2
from .ndarray import CreateExpr, RandomExpr
from .optimize import dag_nodes, optimize
from .outer import OuterExpr, outer
from .reduce import GeneralReduceExpr, ReduceExpr
from .reshape import (ConcatExpr, ReshapeExpr, TransposeExpr, concatenate,
                      ravel, reshape, transpose)
from .shuffle import shuffle
from .slice import SliceExpr, make_slice

__all__ = ["Expr", "ValExpr", "ScalarExpr", "TupleExpr", "as_expr",
           "evaluate", "optimize", "dag_nodes", "map", "MapExpr",
           "ReduceExpr", "CreateExpr", "RandomExpr", "plan_cache_size",
           "clear_plan_cache", "plan_stats", "reset_plan_stats", "dot",
           "DotExpr", "filter", "GatherExpr", "map2", "Map2Expr", "loop",
           "LoopExpr", "LoopItemExpr", "SliceExpr", "make_slice",
           "assign", "write_array", "WriteExpr", "outer", "OuterExpr",
           "GeneralReduceExpr", "shuffle", "transpose", "reshape",
           "TransposeExpr", "ReshapeExpr", "ConcatExpr", "tuple_of",
           "ListExpr", "DictExpr", "dict_of", "lazify", "map_with_location",
           "MapWithLocationExpr", "from_file", "load", "save",
           "dot_shardmap", "DotShardMapExpr", "shard_map2", "ShardMap2Expr",
           ] + [n for n in _builtin_all if n != "dot"]
