"""Notebook-cell frontend: AST → operator DAG (paper §4.1–§4.2).

The paper intercepts code between the Jupyter front-end and the Python shell,
parsing each cell into the operator DAG.  We do the same for a pandas-flavoured
subset: ``pd.read_csv``, method chains, subscript filters, column assignment,
UDF application.  The *trailing expression* of a cell is the interaction
(Jupyter display semantics); everything else is specification only.
"""
from __future__ import annotations

import ast
import operator
from typing import Any, Dict, Optional

from .api import (
    ColExpr,
    ColumnRef,
    ColumnsHandle,
    DataFrame,
    GroupBy,
    Predicate,
    ScalarHandle,
    SeriesLike,
    Session,
)


class _PandasModule:
    """Stand-in for the ``pd`` name inside cells."""

    def __init__(self, session: Session):
        self._session = session

    def read_csv(self, name: str) -> DataFrame:
        return self._session.read_table(name)

    read_table = read_csv


class CellRunner:
    def __init__(self, session: Session, env: Optional[Dict[str, Any]] = None):
        self.session = session
        self.env: Dict[str, Any] = {"pd": _PandasModule(session)}
        if env:
            self.env.update(env)

    # ------------------------------------------------------------------ cells --
    def run_cell(self, code: str) -> Any:
        tree = ast.parse(code)
        result = None
        for i, stmt in enumerate(tree.body):
            last = i == len(tree.body) - 1
            if isinstance(stmt, ast.Assign):
                value = self._eval(stmt.value)
                for target in stmt.targets:
                    self._bind(target, value)
                result = None
            elif isinstance(stmt, ast.Expr):
                value = self._eval(stmt.value)
                if last and value is not None:
                    result = self.session.show(value)
                else:
                    result = None
            elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
                continue  # imports are environment no-ops here
            elif isinstance(stmt, ast.FunctionDef):
                # allow defining UDFs inline
                ns: Dict[str, Any] = {}
                exec(  # noqa: S102 - notebook cells are user code by definition
                    compile(ast.Module(body=[stmt], type_ignores=[]), "<cell>", "exec"),
                    self.env,
                    ns,
                )
                self.env.update(ns)
            else:
                raise SyntaxError(
                    f"unsupported statement {type(stmt).__name__} in cell"
                )
        return result

    def _bind(self, target: ast.expr, value: Any) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = value
            return
        if isinstance(target, ast.Subscript):
            obj = self._eval(target.value)
            key = self._eval(target.slice)
            if isinstance(obj, DataFrame):
                obj[key] = value
                return
        raise SyntaxError("unsupported assignment target")

    # ----------------------------------------------------------------- exprs --
    def _eval(self, node: ast.expr) -> Any:
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            try:
                return self.env[node.id]
            except KeyError:
                raise NameError(f"name {node.id!r} is not defined in this cell") from None
        if isinstance(node, ast.List):
            return [self._eval(e) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(self._eval(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return {
                self._eval(k): self._eval(v) for k, v in zip(node.keys, node.values)
            }
        if isinstance(node, ast.Attribute):
            obj = self._eval(node.value)
            return getattr(obj, node.attr)
        if isinstance(node, ast.Subscript):
            obj = self._eval(node.value)
            key = self._eval(node.slice)
            return obj[key]
        if isinstance(node, ast.Call):
            fn = self._eval(node.func)
            args = [self._eval(a) for a in node.args]
            kwargs = {kw.arg: self._eval(kw.value) for kw in node.keywords}
            return fn(*args, **kwargs)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise SyntaxError("chained comparisons unsupported")
            left = self._eval(node.left)
            right = self._eval(node.comparators[0])
            return _CMP_OPS[type(node.ops[0])](left, right)
        if isinstance(node, ast.BinOp):
            left = self._eval(node.left)
            right = self._eval(node.right)
            return _BIN_OPS[type(node.op)](left, right)
        if isinstance(node, ast.UnaryOp):
            val = self._eval(node.operand)
            if isinstance(node.op, ast.Invert):
                return ~val
            if isinstance(node.op, ast.USub):
                return -val
            if isinstance(node.op, ast.Not):
                return ~val
        if isinstance(node, ast.Lambda):
            code = compile(ast.Expression(body=node), "<cell-lambda>", "eval")
            return eval(code, self.env)  # noqa: S307
        raise SyntaxError(f"unsupported expression {ast.dump(node)[:80]}")


_CMP_OPS = {
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
}

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.BitAnd: operator.and_,
    ast.BitOr: operator.or_,
}
