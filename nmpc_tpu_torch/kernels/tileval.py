"""Code generator: a problem's per-stage callables as scalar CUDA C++.

Counterpart of ``nmpc_tpu/kernels/tileval.py`` (the jaxpr tile
interpreter) and of ``ddp_backward_remat.py::_hoist``.  The remat backward
(``ddp_backward_remat.py``) and the fused line-search rollouts
(``ddp_forward_remat.py``) evaluate the problem's dynamics, costs and
their derivatives inside one CUDA thread per lane; this module turns the
problem's Python callables into that device code.  Four steps:

* **trace** each callable once with ``make_fx`` at scalar shapes
  (t ``[]``, x ``[nx]``, u ``[nu]``, the solve dtype), in fake-tensor
  mode so that data-dependent Python control flow refuses to trace; the
  derivative groups are ``torch.func`` transforms traced the same way
  (``dyn_jvp``, ``cost_grad``, ``cost_grad_jvp``), or the problem's
  analytic ``dynamics_derivs`` / ``running_cost_derivs``; the ``aux``
  group gives a stage's input mask and box bounds from its time, as
  ``solvers/stages.py`` computes them;
* **scalarize** every graph value of small shape into a flat row-major
  list of elements, each an SSA scalar (:class:`Var`) or a Python
  literal: selects, stacks, expands, views and aliases are re-indexing,
  zero tensors and captured constants become literals, size and storage
  checks are static;
* **fold** literals as the JAX interpreter does: ``0*x -> 0``,
  ``1*x -> x``, ``x+0 -> x``, ``x-0 -> x``, and literal op literal
  evaluated at the value's dtype, so the jvp groups evaluated with
  one-hot literal seeds fold into the analytic partial derivatives; equal
  (op, operands) pairs are shared across the jvp columns (CSE);
* **emit** the scalar program as a C++ function templated on ``T``
  (:meth:`Program.emit_cpp`, ``__host__ __device__`` under nvcc) and,
  for the tests, evaluate it with torch ops (:meth:`Program.evaluate`).

Fold contract (the JAX package's, ``nmpc_tpu/kernels/tileval.py:35-39``):
``0*x`` folds to ``0`` even where ``x`` could be non-finite.  Literal
zeros arise only in derivative tangents, where ``torch.func``'s own zero
tensors skip the product in the same way; a NaN lane still reaches the
Riccati stage through its primal values and fails there.

The generated program keeps the traced op order and dtypes: where
``torch.func`` computes a tangent in float64 inside a float32 solve (its
zero tangents of Python scalars promote), the program does too, and the
result is cast to the solve dtype as ``_stage_derivs`` casts it.

Unsupported ops, data-dependent control flow and values of more than
``MAX_ELEMS`` elements raise :class:`TileEvalError`; the solver's ``auto``
rule asks :func:`tile_supported` first (through ``remat_supported`` and
``forward_remat_supported`` of the kernel modules).
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
from typing import NamedTuple

import torch
from torch import func
from torch.fx.experimental.proxy_tensor import make_fx

from nmpc_tpu_torch.solvers.stages import _stage_bounds

MAX_ELEMS = 256
# make_fx's tracing state is process-wide: one trace at a time (two
# threads tracing at once crashed the interpreter).
_TRACE_LOCK = threading.Lock()


class TileEvalError(NotImplementedError):
    """A callable, op or size the generator does not support."""


class Var:
    """One SSA scalar of a :class:`Program`."""

    __slots__ = ("index", "op", "args", "dtype")

    def __init__(self, index, op, args, dtype):
        self.index, self.op, self.args, self.dtype = index, op, args, dtype

    def __repr__(self):
        return f"v{self.index}"


def _is_lit(e) -> bool:
    return not isinstance(e, Var)


def _lit(value, dtype):
    """A Python value as a literal of ``dtype`` (rounded as a cast would)."""
    if dtype == torch.bool:
        return bool(value)
    if not dtype.is_floating_point:
        return int(value)
    return torch.tensor(float(value), dtype=torch.float64).to(dtype).item()


def _key(e):
    if isinstance(e, Var):
        return ("v", e.index)
    if isinstance(e, float):
        return ("f", e.hex())
    return (type(e).__name__, e)


# Scalar ops: name -> (torch function, C++ format).
_FLOAT_UNARY = ("neg", "sin", "cos", "tan", "exp", "log", "sqrt", "tanh",
                "abs", "asin", "acos", "atan", "sinh", "cosh", "log1p",
                "expm1", "floor", "ceil")
_OPS = {
    "add": (torch.add, "({0} + {1})"),
    "sub": (torch.sub, "({0} - {1})"),
    "mul": (torch.mul, "({0} * {1})"),
    "div": (torch.div, "({0} / {1})"),
    "pow": (torch.pow, "pow({0}, {1})"),
    "atan2": (torch.atan2, "atan2({0}, {1})"),
    "gt": (torch.gt, "({0} > {1})"),
    "lt": (torch.lt, "({0} < {1})"),
    "ge": (torch.ge, "({0} >= {1})"),
    "le": (torch.le, "({0} <= {1})"),
    "eq": (torch.eq, "({0} == {1})"),
    "ne": (torch.ne, "({0} != {1})"),
    "and": (torch.logical_and, "({0} && {1})"),
    "or": (torch.logical_or, "({0} || {1})"),
    "not": (torch.logical_not, "(!{0})"),
    "where": (torch.where, "({0} ? {1} : {2})"),
    "neg": (torch.neg, "(-{0})"),
    "abs": (torch.abs, "fabs({0})"),
    **{n: (getattr(torch, n), n + "({0})") for n in _FLOAT_UNARY
       if n not in ("neg", "abs")},
}
_COMPARE = ("gt", "lt", "ge", "le", "eq", "ne")

_CTYPES = {torch.float32: "float", torch.float64: "double",
           torch.bool: "bool", torch.int64: "long long",
           torch.int32: "int"}


class Program:
    """An SSA program of scalar ops on named scalar arguments.

    :meth:`op` folds literals and shares equal (op, operands) pairs, so a
    program built from several traced groups (the jvp columns of one
    stage) computes each primal sub-expression once."""

    def __init__(self, dtype):
        self.dtype = dtype          # the solve dtype, emitted as T
        self.vars: list[Var] = []
        self.memo: dict = {}

    def arg(self, name: str, dtype) -> Var:
        return self._new("arg", (name,), dtype)

    def _new(self, op, args, dtype):
        var = Var(len(self.vars), op, args, dtype)
        self.vars.append(var)
        return var

    def cast(self, e, dtype):
        if _is_lit(e):
            return _lit(e, dtype)
        if e.dtype == dtype:
            return e
        if (e.op == "cast" and e.args[0].dtype == dtype
                and e.dtype.is_floating_point and dtype.is_floating_point
                and torch.finfo(e.dtype).bits > torch.finfo(dtype).bits):
            return e.args[0]        # narrow(widen(v)) is v exactly
        return self._op("cast", (e,), dtype)

    def op(self, name: str, args, dtype):
        """Fold or emit ``name(*args)`` with result ``dtype``; operands are
        already at their compute dtype."""
        if all(_is_lit(a) for a in args):
            return self._eval_literal(name, args, dtype)
        if name == "mul":
            for a, b in (args, args[::-1]):
                if _is_lit(a) and a == 0:
                    return _lit(0, dtype)
                if _is_lit(a) and a == 1:
                    return b
        elif name == "add":
            for a, b in (args, args[::-1]):
                if _is_lit(a) and a == 0:
                    return b
        elif name == "sub":
            if _is_lit(args[1]) and args[1] == 0:
                return args[0]
        elif name == "where" and _is_lit(args[0]):
            return args[1] if args[0] else args[2]
        return self._op(name, tuple(args), dtype)

    def _op(self, name, args, dtype):
        key = (name, tuple(_key(a) for a in args), dtype)
        found = self.memo.get(key)
        if found is None:
            found = self.memo[key] = self._new(name, args, dtype)
        return found

    def _eval_literal(self, name, args, dtype):
        if name == "cast":
            return _lit(args[0], dtype)
        if name == "where":
            return args[1] if args[0] else args[2]
        operand_dtype = dtype if name not in _COMPARE else None
        ts = [torch.tensor(a, dtype=operand_dtype or _lit_dtype(a))
              for a in args]
        return _lit(_OPS[name][0](*ts).item(), dtype)

    # -- consumers ----------------------------------------------------------

    def live(self, outputs) -> list[Var]:
        """Vars the ``outputs`` depend on, in program order."""
        seen = set()
        stack = [e for e in outputs if not _is_lit(e)]
        while stack:
            var = stack.pop()
            if var.index in seen:
                continue
            seen.add(var.index)
            stack.extend(a for a in var.args if isinstance(a, Var))
        return [v for v in self.vars if v.index in seen]

    def evaluate(self, outputs, inputs: dict, like: torch.Tensor):
        """Run the program with torch ops: ``inputs`` maps argument names to
        tensors of one batch shape (``like``'s); returns a tensor per
        output.  A test tool: no solver path runs it."""
        vals = {}

        def get(e, dtype):
            if _is_lit(e):
                return torch.tensor(e, dtype=dtype, device=like.device)
            return vals[e.index]

        for var in self.live(outputs):
            if var.op == "arg":
                vals[var.index] = inputs[var.args[0]].to(var.dtype)
            elif var.op == "cast":
                vals[var.index] = vals[var.args[0].index].to(var.dtype)
            else:
                fn = _OPS[var.op][0]
                dts = _operand_dtypes(var)
                vals[var.index] = fn(*(get(a, d) for a, d in
                                       zip(var.args, dts))).to(var.dtype)
        out = []
        for e in outputs:
            v = get(e, self.dtype) if _is_lit(e) else vals[e.index]
            out.append(torch.broadcast_to(v, like.shape).to(self.dtype))
        return out

    def emit_cpp(self, name: str, params: str, outputs, out_names) -> str:
        """A C++ function ``name`` templated on ``T`` (the solve dtype)
        that writes each output element to the lvalue in ``out_names``.
        ``params`` declares the arguments the program's ``arg`` ops read
        (e.g. ``T t, const T* x``); argument ``x[2]`` is named ``x_2``
        inside the program."""
        lines = [f"template <typename T>\nNMPC_FN void {name}({params}) {{"]
        for var in self.live(outputs):
            ctype = self._ctype(var.dtype)
            if var.op == "arg":
                expr = _arg_lvalue(var.args[0])
            elif var.op == "cast":
                expr = f"static_cast<{ctype}>({self._cpp(var.args[0], None)})"
            else:
                dts = _operand_dtypes(var)
                expr = _OPS[var.op][1].format(
                    *(self._cpp(a, d) for a, d in zip(var.args, dts)))
            lines.append(f"  const {ctype} v{var.index} = {expr};")
        for lvalue, e in zip(out_names, outputs):
            value = self._cpp(self.cast(e, self.dtype), self.dtype)
            lines.append(f"  {lvalue} = {value};")
        lines.append("}\n")
        return "\n".join(lines)

    def _ctype(self, dtype):
        if dtype == self.dtype:
            return "T"
        if dtype not in _CTYPES:
            raise TileEvalError(f"no C++ type for {dtype}")
        return _CTYPES[dtype]

    def _cpp(self, e, dtype):
        if isinstance(e, Var):
            return repr(e)
        if isinstance(e, bool):
            return "true" if e else "false"
        ctype = self._ctype(dtype if dtype is not None else _lit_dtype(e))
        if isinstance(e, int):
            return f"static_cast<{ctype}>({e})"
        if math.isnan(e):
            return f"{ctype}(NAN)"
        if math.isinf(e):
            return f"({'-' if e < 0 else ''}{ctype}(HUGE_VAL))"
        return f"{ctype}({e!r})"


def _lit_dtype(e):
    if isinstance(e, bool):
        return torch.bool
    if isinstance(e, int):
        return torch.int64
    return torch.float64


def _operand_dtypes(var):
    """The dtype each operand of ``var`` is at (literals carry none)."""
    if var.op == "where":
        return (torch.bool, var.dtype, var.dtype)
    if var.op in _COMPARE:
        d = next(a.dtype for a in var.args if isinstance(a, Var))
        return (d,) * len(var.args)
    if var.op in ("and", "or", "not"):
        return (torch.bool,) * len(var.args)
    return (var.dtype,) * len(var.args)


def _arg_lvalue(name: str) -> str:
    base, _, idx = name.partition("_")
    return f"{base}[{idx}]" if idx else base


# --------------------------------------------------------------------------
# scalarizing an fx graph
# --------------------------------------------------------------------------


class SVal(NamedTuple):
    """A graph value of small static shape: flat row-major elements."""

    shape: tuple
    dtype: torch.dtype
    elems: list

    def at(self, idx):
        flat = 0
        for i, s in zip(idx, self.shape):
            flat = flat * s + i
        return self.elems[flat]


def _indices(shape):
    return itertools.product(*(range(s) for s in shape))


def _numel(shape):
    return math.prod(shape)


def _meta(node):
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise TileEvalError(f"{node.target}: no tensor metadata")
    shape = tuple(int(s) for s in val.shape)
    if _numel(shape) > MAX_ELEMS:
        raise TileEvalError(f"{node.target}: {shape} exceeds {MAX_ELEMS} "
                            "elements")
    return shape, val.dtype


def _bcast(v, idx, out_shape):
    """Element of ``v`` (SVal or Python number) at output index ``idx``
    under broadcasting."""
    if not isinstance(v, SVal):
        return v
    off = len(out_shape) - len(v.shape)
    return v.at(tuple(0 if s == 1 else idx[off + d]
                      for d, s in enumerate(v.shape)))


def _dummy(v):
    if isinstance(v, SVal):
        return torch.zeros(v.shape, dtype=v.dtype)
    return v


class _Graph:
    """Evaluate one traced graph on SVals inside a :class:`Program`."""

    def __init__(self, prog: Program, gm):
        self.prog, self.gm = prog, gm

    def run(self, args):
        env = {}
        it = iter(args)

        def read(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (list, tuple)):
                return type(a)(read(b) for b in a)
            if isinstance(a, dict):
                return {k: read(b) for k, b in a.items()}
            return a

        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(it)
            elif node.op == "get_attr":
                const = getattr(self.gm, node.target)
                if const.numel() > MAX_ELEMS:
                    raise TileEvalError(f"constant {node.target} of "
                                        f"{const.numel()} elements")
                env[node] = SVal(tuple(const.shape), const.dtype,
                                 [_lit(v, const.dtype) for v in
                                  const.detach().reshape(-1).tolist()])
            elif node.op == "call_function":
                handler = _HANDLERS.get(str(node.target))
                if handler is None:
                    raise TileEvalError(f"unsupported op {node.target}")
                try:
                    env[node] = handler(self, node, *read(node.args),
                                        **read(node.kwargs))
                except (TypeError, ValueError, IndexError, KeyError) as exc:
                    # an overload called in a form the table does not know
                    raise TileEvalError(f"{node.target}: {exc}") from exc
            elif node.op == "output":
                return read(node.args[0])
            else:
                raise TileEvalError(f"unsupported graph node {node.op}")
        raise TileEvalError("graph without output")

    # -- helpers used by the handlers --------------------------------------

    def elementwise(self, node, name, *operands, compute=None):
        shape, dtype = _meta(node)
        if compute is None:
            compute = dtype
        out = []
        for idx in _indices(shape):
            es = [self.prog.cast(_bcast(v, idx, shape), compute)
                  for v in operands]
            out.append(self.prog.op(name, es, dtype))
        return SVal(shape, dtype, out)

    def reindex(self, node, src: SVal, pick):
        """Output element at idx = ``src.at(pick(idx))``."""
        shape, dtype = _meta(node)
        return SVal(shape, dtype, [src.at(pick(idx)) for idx in
                                   _indices(shape)])

    def filled(self, node, value):
        shape, dtype = _meta(node)
        return SVal(shape, dtype, [_lit(value, dtype)] * _numel(shape))

    def total(self, elems, dtype):
        acc = _lit(0, dtype)
        for e in elems:
            acc = self.prog.op("add", (acc, self.prog.cast(e, dtype)), dtype)
        return acc


def _h_binary(name):
    def handler(g, node, a, b, alpha=1):
        if alpha != 1:
            b = g.elementwise(node, "mul", b, alpha) if isinstance(
                b, SVal) else b * alpha
        return g.elementwise(node, name, a, b)
    return handler


def _h_rsub(g, node, a, b, alpha=1):
    return _h_binary("sub")(g, node, b, a, alpha) if alpha == 1 else (
        g.elementwise(node, "sub", b, g.elementwise(node, "mul", a, alpha)))


def _h_compare(name):
    def handler(g, node, a, b):
        compute = torch.result_type(_dummy(a), _dummy(b))
        return g.elementwise(node, name, a, b, compute=compute)
    return handler


def _h_unary(name):
    def handler(g, node, a):
        return g.elementwise(node, name, a)
    return handler


def _h_pow_scalar(g, node, a, e):
    """``x ** e`` for a literal exponent, lowered as torch lowers it."""
    if e == 2:
        return g.elementwise(node, "mul", a, a)
    if e == 1:
        return g.elementwise(node, "mul", a, 1)
    if e == 0:
        return g.filled(node, 1)
    if e == 3:
        return g.elementwise(node, "mul", g.elementwise(node, "mul", a, a), a)
    if e == 0.5:
        return g.elementwise(node, "sqrt", a)
    if e == -1:
        return g.elementwise(node, "div", 1, a)
    return g.elementwise(node, "pow", a, e)


def _h_sum(g, node, a, dims=None, keepdim=False, dtype=None):
    shape, out_dtype = _meta(node)
    if not dims:
        dims = range(len(a.shape))
    dims = sorted(d % len(a.shape) for d in dims)
    kept = [d for d in range(len(a.shape)) if d not in dims]
    out = []
    for idx in _indices(tuple(a.shape[d] for d in kept)):
        elems = []
        for r in _indices(tuple(a.shape[d] for d in dims)):
            full = [0] * len(a.shape)
            for d, i in zip(kept, idx):
                full[d] = i
            for d, i in zip(dims, r):
                full[d] = i
            elems.append(a.at(tuple(full)))
        out.append(g.total(elems, out_dtype))
    return SVal(shape, out_dtype, out)


def _h_contract(g, node, a, b):
    """dot / mv / mm: left-to-right sums over the shared axis."""
    shape, dtype = _meta(node)
    out = []
    for idx in _indices(shape):
        ia = idx[:len(a.shape) - 1]
        ib = idx[len(a.shape) - 1:]
        terms = []
        for k in range(a.shape[-1]):
            ea = g.prog.cast(a.at(ia + (k,)), dtype)
            eb = g.prog.cast(b.at((k,) + ib), dtype)
            terms.append(g.prog.op("mul", (ea, eb), dtype))
        out.append(g.total(terms, dtype))
    return SVal(shape, dtype, out)


def _h_select(g, node, a, dim, index):
    dim %= len(a.shape)
    index %= a.shape[dim]
    return g.reindex(node, a, lambda i: i[:dim] + (index,) + i[dim:])


def _h_slice(g, node, a, dim=0, start=None, end=None, step=1):
    dim %= len(a.shape)
    start = 0 if start is None else (start % a.shape[dim] if start < 0
                                     else start)
    return g.reindex(node, a, lambda i: i[:dim] + (start + step * i[dim],)
                     + i[dim + 1:])


def _h_stack(g, node, tensors, dim=0):
    shape, dtype = _meta(node)
    dim %= len(shape)
    out = [g.prog.cast(tensors[i[dim]].at(i[:dim] + i[dim + 1:]), dtype)
           for i in _indices(shape)]
    return SVal(shape, dtype, out)


def _h_cat(g, node, tensors, dim=0):
    shape, dtype = _meta(node)
    tensors = [t for t in tensors if _numel(t.shape) > 0]
    dim %= len(shape)
    out = []
    for i in _indices(shape):
        off = i[dim]
        for t in tensors:
            if off < t.shape[dim]:
                out.append(g.prog.cast(t.at(i[:dim] + (off,) + i[dim + 1:]),
                                       dtype))
                break
            off -= t.shape[dim]
    return SVal(shape, dtype, out)


def _h_same(g, node, a, *args, **kwargs):
    """alias / clone / detach / contiguous / views: same elements."""
    shape, dtype = _meta(node)
    if _numel(shape) != len(a.elems):
        raise TileEvalError(f"{node.target}: {a.shape} -> {shape}")
    return SVal(shape, dtype, [g.prog.cast(e, dtype) for e in a.elems])


def _h_expand(g, node, a, *args, **kwargs):
    shape, dtype = _meta(node)
    return SVal(shape, dtype, [g.prog.cast(_bcast(a, i, shape), dtype)
                               for i in _indices(shape)])


def _h_permute(g, node, a, dims):
    dims = [d % len(a.shape) for d in dims]

    def pick(i):
        src = [0] * len(dims)
        for k, d in enumerate(dims):
            src[d] = i[k]
        return tuple(src)
    return g.reindex(node, a, pick)


def _h_transpose(g, node, a, d0=0, d1=1):
    n = len(a.shape)
    dims = list(range(n))
    if n >= 2:
        d0, d1 = d0 % n, d1 % n
        dims[d0], dims[d1] = dims[d1], dims[d0]
    return _h_permute(g, node, a, dims)


def _h_where(g, node, cond, a, b):
    shape, dtype = _meta(node)
    out = []
    for idx in _indices(shape):
        c = g.prog.cast(_bcast(cond, idx, shape), torch.bool)
        ea = g.prog.cast(_bcast(a, idx, shape), dtype)
        eb = g.prog.cast(_bcast(b, idx, shape), dtype)
        out.append(g.prog.op("where", (c, ea, eb), dtype))
    return SVal(shape, dtype, out)


def _h_bool_binary(name):
    """``&`` / ``|`` of two masks: logical on bools, refused on integers
    (bitwise there)."""
    def handler(g, node, a, b):
        if _meta(node)[1] != torch.bool:
            raise TileEvalError(f"{node.target} on integers")
        return g.elementwise(node, name, a, b)
    return handler


def _h_fill(value):
    def handler(g, node, *args, **kwargs):
        return g.filled(node, value)
    return handler


def _h_full(g, node, size, value, **kwargs):
    return g.filled(node, value)


def _h_full_like(g, node, a, value, **kwargs):
    return g.filled(node, value)


def _h_eye(g, node, *args, **kwargs):
    shape, dtype = _meta(node)
    return SVal(shape, dtype, [_lit(i[0] == i[1], dtype)
                               for i in _indices(shape)])


def _h_static_true(g, node, *args, **kwargs):
    return True


_HANDLERS = {}
for _name in ("add", "sub", "mul", "div"):
    for _ov in (f"aten.{_name}.Tensor", f"aten.{_name}.Scalar",
                f"prims.{_name}.default"):
        _HANDLERS[_ov] = _h_binary(_name)
for _name in _COMPARE:
    for _ov in (f"aten.{_name}.Tensor", f"aten.{_name}.Scalar",
                f"prims.{_name}.default"):
        _HANDLERS[_ov] = _h_compare(_name)
for _name in _FLOAT_UNARY:
    _HANDLERS[f"aten.{_name}.default"] = _h_unary(_name)
    _HANDLERS[f"prims.{_name}.default"] = _h_unary(_name)
_HANDLERS.update({
    "aten.rsub.Scalar": _h_rsub,
    "aten.rsub.Tensor": _h_rsub,
    "aten.atan2.default": _h_binary("atan2"),
    "aten.pow.Tensor_Tensor": _h_binary("pow"),
    "aten.pow.Tensor_Scalar": _h_pow_scalar,
    "aten.reciprocal.default": lambda g, n, a: g.elementwise(n, "div", 1, a),
    "aten.rsqrt.default": lambda g, n, a: g.elementwise(
        n, "div", 1, g.elementwise(n, "sqrt", a)),
    "aten.logical_not.default": _h_unary("not"),
    "aten.logical_and.default": _h_binary("and"),
    "aten.logical_or.default": _h_binary("or"),
    "aten.bitwise_and.Tensor": _h_bool_binary("and"),
    "aten.bitwise_or.Tensor": _h_bool_binary("or"),
    "aten.where.self": _h_where,
    "aten.sum.default": _h_sum,
    "aten.sum.dim_IntList": _h_sum,
    "aten.dot.default": _h_contract,
    "aten.mv.default": _h_contract,
    "aten.mm.default": _h_contract,
    "aten.select.int": _h_select,
    "aten.slice.Tensor": _h_slice,
    "aten.stack.default": _h_stack,
    "aten.cat.default": _h_cat,
    "aten.expand.default": _h_expand,
    "aten.permute.default": _h_permute,
    "aten.t.default": _h_transpose,
    "aten.transpose.int": _h_transpose,
    "aten.zeros_like.default": _h_fill(0),
    "aten.ones_like.default": _h_fill(1),
    "aten.full_like.default": _h_full_like,
    "aten.zeros.default": _h_fill(0),
    "aten.ones.default": _h_fill(1),
    "aten.full.default": _h_full,
    "aten.new_zeros.default": _h_fill(0),
    "aten.new_ones.default": _h_fill(1),
    "aten._efficientzerotensor.default": _h_fill(0),
    "aten.eye.default": _h_eye,
    "aten.scalar_tensor.default": lambda g, n, v, **kw: g.filled(n, v),
    "aten.is_same_size.default": _h_static_true,
    "aten._has_same_storage_numel.default": _h_static_true,
    "prims.convert_element_type.default": _h_same,
})
for _name in ("alias", "clone", "detach", "lift_fresh_copy", "_to_copy",
              "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
              "contiguous", "flatten"):
    for _ov in ("default", "dim", "dims", "using_ints"):
        _HANDLERS[f"aten.{_name}.{_ov}"] = _h_same


# --------------------------------------------------------------------------
# tracing the problem's groups
# --------------------------------------------------------------------------


def _group_fn(problem, which):
    """(callable, argument kinds) of one traced group."""
    if which == "dyn":
        return problem.dynamics, "txu"
    if which == "cost":
        return problem.running_cost, "txu"
    if which == "term":
        return problem.terminal_cost, "tx"
    if which == "dyn_derivs":
        return problem.dynamics_derivs, "txu"
    if which == "cost_derivs":
        return problem.running_cost_derivs, "txu"
    if which == "cost_grad":
        return func.grad(problem.running_cost, argnums=(1, 2)), "txu"
    if which == "dyn_jvp":
        def dyn_jvp(t, x, u, dx, du):
            return func.jvp(lambda xx, uu: problem.dynamics(t, xx, uu),
                            (x, u), (dx, du))[1]
        return dyn_jvp, "txuxu"
    if which == "aux":
        def aux(t, x, u):
            """(mask, lower, upper) of one stage as ``_stage_derivs``
            computes them (nmpc_tpu/kernels/ddp_backward_remat.py:119-134)."""
            if problem.input_mask is None:
                mask = torch.ones((problem.input_dim,), dtype=x.dtype)
                lower, upper, _ = _stage_bounds(problem, t, u)
            else:
                mask = problem.input_mask(t).to(x.dtype)
                lower, upper, _ = _stage_bounds(problem, t, u, mask)
            return mask, lower, upper
        return aux, "txu"
    if which == "cost_grad_jvp":
        grad = func.grad(problem.running_cost, argnums=(1, 2))

        def cost_grad_jvp(t, x, u, dx, du):
            return func.jvp(lambda xx, uu: grad(t, xx, uu), (x, u),
                            (dx, du))[1]
        return cost_grad_jvp, "txuxu"
    raise ValueError(which)


@functools.lru_cache(maxsize=256)
def _trace(problem, which: str, nx: int, nu: int, dtype):
    """Trace one group at scalar shapes: the graph, or the TileEvalError
    it raised (cached either way, so a rejected problem is traced once).

    The callables run once on real CPU tensors first, so that a problem
    that caches tensors per (device, dtype) caches real ones; the trace
    itself runs on fake tensors, so Python control flow that reads a
    value cannot trace."""
    fn, kinds = _group_fn(problem, which)
    shapes = {"t": (), "x": (nx,), "u": (nu,)}
    args = [torch.zeros(shapes[k], dtype=dtype) for k in kinds]
    try:
        with _TRACE_LOCK:
            fn(*args)
            return make_fx(fn, tracing_mode="fake",
                           _allow_non_fake_inputs=True)(*args)
    except TileEvalError as exc:
        return exc
    except Exception as exc:  # noqa: BLE001 - any trace failure rejects
        return TileEvalError(f"{which} does not trace: "
                             f"{type(exc).__name__}: {exc}")


def _call(prog, problem, which, nx, nu, args, shapes):
    """Evaluate group ``which`` on ``args``; its outputs must have
    ``shapes`` (a shape, or a tuple of shapes for a tuple output)."""
    gm = _trace(problem, which, nx, nu, prog.dtype)
    if isinstance(gm, TileEvalError):
        raise gm
    out = _Graph(prog, gm).run(args)
    got = (out.shape if isinstance(out, SVal)
           else tuple(v.shape for v in out))
    if got != shapes:
        raise TileEvalError(f"{which} gave shapes {got}, expected {shapes}")
    return out


def _vec(prog, elems):
    return SVal((len(elems),), prog.dtype, list(elems))


def _scalar(prog, e):
    return SVal((), prog.dtype, [e])


def _onehot(prog, n, c):
    return _vec(prog, [_lit(1 if a == c else 0, prog.dtype)
                       for a in range(n)])


class Unit(NamedTuple):
    """The generated device functions of one problem at one dtype."""

    cpp: str         # the C++ functions, templated on T
    functions: dict  # name -> (Program, outputs, arg names)


FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Luu", "Lxu")


def _field_program(problem, nx, nu, dtype):
    """One stage's Riccati fields from (t, x, u), as ``_stage_derivs``:
    returns (Program, outputs in FIELDS order, row-major)."""
    prog = Program(dtype)
    t = prog.arg("t", dtype)
    x = [prog.arg(f"x_{a}", dtype) for a in range(nx)]
    u = [prog.arg(f"u_{a}", dtype) for a in range(nu)]
    tv, xv, uv = _scalar(prog, t), _vec(prog, x), _vec(prog, u)
    zero = _lit(0, dtype)
    zx, zu = _vec(prog, [zero] * nx), _vec(prog, [zero] * nu)

    def call(which, shapes, *args):
        return _call(prog, problem, which, nx, nu, args, shapes)

    grads = ((nx,), (nu,))
    if problem.dynamics_derivs is not None:
        FxV, FuV = call("dyn_derivs", ((nx, nx), (nx, nu)), tv, xv, uv)
        Fx = [[FxV.at((r, c)) for c in range(nx)] for r in range(nx)]
        Fu = [[FuV.at((r, c)) for c in range(nu)] for r in range(nx)]
    else:
        Fx = [[None] * nx for _ in range(nx)]
        Fu = [[None] * nu for _ in range(nx)]
        for c in range(nx):
            col = call("dyn_jvp", (nx,), tv, xv, uv, _onehot(prog, nx, c),
                       zu)
            for r in range(nx):
                Fx[r][c] = col.elems[r]
        for c in range(nu):
            col = call("dyn_jvp", (nx,), tv, xv, uv, zx,
                       _onehot(prog, nu, c))
            for r in range(nx):
                Fu[r][c] = col.elems[r]
    if problem.running_cost_derivs is not None:
        LxV, LuV, LxxV, LuuV, LxuV = call(
            "cost_derivs", grads + ((nx, nx), (nu, nu), (nx, nu)), tv, xv,
            uv)
        Lx, Lu = list(LxV.elems), list(LuV.elems)
        Lxx = [[LxxV.at((r, c)) for c in range(nx)] for r in range(nx)]
        Luu = [[LuuV.at((r, c)) for c in range(nu)] for r in range(nu)]
        Lxu = [[LxuV.at((r, c)) for c in range(nu)] for r in range(nx)]
    else:
        LxV, LuV = call("cost_grad", grads, tv, xv, uv)
        Lx, Lu = list(LxV.elems), list(LuV.elems)
        Lxx = [[None] * nx for _ in range(nx)]
        Luu = [[None] * nu for _ in range(nu)]
        Lxu = [[None] * nu for _ in range(nx)]
        for c in range(nx):
            gx, gu = call("cost_grad_jvp", grads, tv, xv, uv,
                          _onehot(prog, nx, c), zu)
            for r in range(nx):
                Lxx[r][c] = gx.elems[r]
            for r in range(nu):
                Lxu[c][r] = gu.elems[r]      # d2l / dx_c du_r
        for c in range(nu):
            gx, gu = call("cost_grad_jvp", grads, tv, xv, uv, zx,
                          _onehot(prog, nu, c))
            for r in range(nu):
                Luu[r][c] = gu.elems[r]
    cast = lambda rows: [[prog.cast(e, dtype) for e in row] for row in rows]
    Fx, Fu, Lxx, Luu, Lxu = map(cast, (Fx, Fu, Lxx, Luu, Lxu))
    Lx, Lu = (cast([v])[0] for v in (Lx, Lu))
    if problem.input_mask is not None:
        # the masked-dimension embedding of _stage_derivs, op for op
        mask, _, _ = call("aux", ((nu,), (nu,), (nu,)), tv, xv, uv)
        m = [prog.cast(e, dtype) for e in mask.elems]
        mul = lambda a, b: prog.op("mul", (a, b), dtype)
        Fu = [[mul(Fu[r][c], m[c]) for c in range(nu)] for r in range(nx)]
        Lu = [mul(Lu[c], m[c]) for c in range(nu)]
        Luu = [[prog.op("add", (mul(Luu[r][c], mul(m[r], m[c])),
                                prog.op("sub", (_lit(1, dtype), m[r]), dtype)
                                if r == c else _lit(0, dtype)), dtype)
                for c in range(nu)] for r in range(nu)]
        Lxu = [[mul(Lxu[r][c], m[c]) for c in range(nu)] for r in range(nx)]
    flat = lambda m: [e for row in m for e in row]
    return prog, flat(Fx) + flat(Fu) + Lx + Lu + flat(Lxx) + flat(Luu) + flat(
        Lxu)


def _aux_program(problem, nx, nu, dtype):
    """The boxed stage's bounds from (t, x, u): lower then upper (2 nu
    outputs), as ``_stage_bounds``."""
    prog = Program(dtype)
    t = prog.arg("t", dtype)
    x = [prog.arg(f"x_{a}", dtype) for a in range(nx)]
    u = [prog.arg(f"u_{a}", dtype) for a in range(nu)]
    _, lower, upper = _call(prog, problem, "aux", nx, nu,
                            (_scalar(prog, t), _vec(prog, x), _vec(prog, u)),
                            ((nu,), (nu,), (nu,)))
    return prog, [prog.cast(e, dtype) for e in lower.elems + upper.elems]


def _step_program(problem, nx, nu, dtype):
    """(next state, running cost) from (t, x, u): outputs nx + 1."""
    prog = Program(dtype)
    t = prog.arg("t", dtype)
    x = [prog.arg(f"x_{a}", dtype) for a in range(nx)]
    u = [prog.arg(f"u_{a}", dtype) for a in range(nu)]
    tv, xv, uv = _scalar(prog, t), _vec(prog, x), _vec(prog, u)
    xn = _call(prog, problem, "dyn", nx, nu, (tv, xv, uv), (nx,))
    c = _call(prog, problem, "cost", nx, nu, (tv, xv, uv), ())
    return prog, [prog.cast(e, dtype) for e in xn.elems + c.elems]


def _term_program(problem, nx, nu, dtype):
    prog = Program(dtype)
    t = prog.arg("t", dtype)
    x = [prog.arg(f"x_{a}", dtype) for a in range(nx)]
    c = _call(prog, problem, "term", nx, nu,
              (_scalar(prog, t), _vec(prog, x)), ())
    return prog, [prog.cast(c.elems[0], dtype)]


_PREAMBLE = """\
#ifndef NMPC_FN
#ifdef __CUDACC__
#define NMPC_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define NMPC_FN inline
using std::sin; using std::cos; using std::tan; using std::exp;
using std::log; using std::sqrt; using std::tanh; using std::fabs;
using std::asin; using std::acos; using std::atan; using std::sinh;
using std::cosh; using std::log1p; using std::expm1; using std::floor;
using std::ceil; using std::pow; using std::atan2;
#endif
#endif
"""


@functools.lru_cache(maxsize=64)
def generate(problem, kind: str, nx: int, nu: int, dtype) -> Unit:
    """The device functions of ``kind`` for ``problem`` at ``dtype``
    (cached on (problem, kind, nx, nu, dtype), so solvers rebuilt for the
    same problem reuse them):

    * ``"remat"``: ``fields(t, x, u, f)`` writes the 2nx²+2nx·nu+nx+nu+nu²
      Riccati fields to ``f`` in ``FIELDS`` order, row-major, with the
      problem's input mask applied as ``_stage_derivs`` applies it;
    * ``"remat_boxed"``: ``fields`` and ``aux(t, x, u, o)``, which writes
      the stage's lower and upper bounds (the aux group);
    * ``"forward"``: ``step(t, x, u, xn, c)`` writes the next state and the
      running cost; ``term(t, x, c)`` the terminal cost.

    Raises :class:`TileEvalError` where the problem's callables do not
    generate."""
    if kind in ("remat", "remat_boxed"):
        progs = {"fields": _field_program(problem, nx, nu, dtype) + ("txu",)}
        if kind == "remat_boxed":
            progs["aux"] = _aux_program(problem, nx, nu, dtype) + ("txu",)
    elif kind == "forward":
        progs = {"step": _step_program(problem, nx, nu, dtype) + ("txu",),
                 "term": _term_program(problem, nx, nu, dtype) + ("tx",)}
    else:
        raise ValueError(kind)
    params = {"txu": "T t, const T* x, const T* u",
              "tx": "T t, const T* x"}
    outs = {"fields": ("f", "T* f"), "aux": ("o", "T* o"),
            "step": ("o", "T* o"), "term": ("o", "T* o")}
    parts = [_PREAMBLE]
    for name, (prog, outputs, kinds) in progs.items():
        var, decl = outs[name]
        parts.append(prog.emit_cpp(
            f"gen_{name}", f"{params[kinds]}, {decl}", outputs,
            [f"{var}[{k}]" for k in range(len(outputs))]))
    return Unit("\n".join(parts),
                {name: (prog, outputs) for name, (prog, outputs, _) in
                 progs.items()})


def tile_supported(problem, kind: str, nx: int, nu: int, dtype) -> bool:
    """Whether :func:`generate` accepts ``problem`` (the ``auto`` gate)."""
    try:
        generate(problem, kind, nx, nu, dtype)
    except TileEvalError:
        return False
    return True
