"""Scheme (.io script) frontend: run the reference GUI's example scripts.

The reference embeds Guile with libfive's Scheme bindings and a restricted
evaluator (``reference/gui/interpreter.cpp:22-164``); its example
scenes (``reference/gui/examples/*.io``) are Scheme programs built
from the libfive shape stdlib.  This module is this package's own
analog (a copy of ``mpr_tpu.frontend.scheme``, which is JAX-free): a small Scheme reader + evaluator whose builtins construct
:class:`~mpr_tpu_torch.frontend.tree.Tree` shapes directly, so the reference's
``.io`` scripts load and render here without Guile or libfive.

Covered surface (everything the bundled examples use, plus basics):

* reader: ``(...)``, ``[...]`` vector literals (the libfive-guile reader
  extension), strings with ``\\n``-style escapes, ``;`` comments,
  ``'quote``, ``#t/#f``, line/column tracking for error messages;
* special forms: ``define`` (variable + function forms), ``lambda``,
  ``let``, ``let*``, ``if``, ``cond``, ``begin``, ``and``, ``or``,
  ``quote``, ``set!``, ``sequence`` (libfive's shape-threading macro) and
  ``lambda-shape``;
* numeric builtins that dispatch on Tree vs number, so the same ``+``,
  ``min``, ``sqrt``, ``atan`` ... work inside ``lambda-shape`` bodies;
* the libfive shape stdlib names used by the examples (``circle``,
  ``box``, ``scale-xyz``, ``reflect-xy``, ``extrude-z``, ``text``, ...)
  with libfive call signatures (vectors for points, optional centers);
* scene directives ``set-bounds!`` / ``set-quality!`` / ``set-resolution!``
  recorded on the result.  These are libfive-Studio meshing directives:
  the reference GUI tolerates and ignores them
  (``reference/gui/examples/architecture.io:1-3`` vs
  ``gui/main.cpp``, which never reads them); here the viewer likewise
  ignores them, and ``cli mesh`` honors ``set-bounds!`` as its sampling
  box.

Evaluating a script returns a :class:`ScriptResult`: every top-level
expression that evaluates to a shape is collected, mirroring the reference
interpreter's shape extraction (``gui/interpreter.cpp:125-164``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import font as _font
from . import shapes as _shapes
from . import tree as _tree
from .tree import Tree

__all__ = ["run_string", "run_file", "ScriptResult", "SchemeError"]


class SchemeError(Exception):
    """Script error with 1-based source position, formatted like the
    reference interpreter's error reporting (gui/interpreter.cpp:67-103)."""

    def __init__(self, msg: str, pos: Optional[Tuple[int, int]] = None):
        self.msg = msg
        self.pos = pos
        super().__init__(f"line {pos[0]}, col {pos[1]}: {msg}" if pos
                         else msg)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class Symbol(str):
    """Interned-by-value symbol; carries its source position."""
    __slots__ = ("pos",)


class SList(list):
    """A read list; carries the position of its opening paren."""
    __slots__ = ("pos",)


_STR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}


def _tokenize(src: str):
    """Yield (token, (line, col)); token is a str or a tagged tuple for
    strings: ("str", value)."""
    i, n = 0, len(src)
    line, col = 1, 1
    while i < n:
        c = src[i]
        if c == "\n":
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == ";":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == "#" and i + 1 < n and src[i + 1] == "|":
            depth = 1                      # #| ... |# block comments nest
            i += 2
            col += 2
            while i < n and depth:
                if src[i] == "#" and i + 1 < n and src[i + 1] == "|":
                    depth += 1
                    i += 2
                    col += 2
                elif src[i] == "|" and i + 1 < n and src[i + 1] == "#":
                    depth -= 1
                    i += 2
                    col += 2
                elif src[i] == "\n":
                    i += 1
                    line += 1
                    col = 1
                else:
                    i += 1
                    col += 1
            continue
        pos = (line, col)
        if c in "()[]'":
            yield c, pos
            i += 1
            col += 1
            continue
        if c == '"':
            i += 1
            col += 1
            out = []
            while True:
                if i >= n:
                    raise SchemeError("unterminated string", pos)
                c = src[i]
                if c == '"':
                    i += 1
                    col += 1
                    break
                if c == "\\":
                    if i + 1 >= n:
                        raise SchemeError("unterminated escape", (line, col))
                    out.append(_STR_ESCAPES.get(src[i + 1], src[i + 1]))
                    i += 2
                    col += 2
                    continue
                if c == "\n":
                    line += 1
                    col = 1
                else:
                    col += 1
                out.append(c)
                i += 1
            yield ("str", "".join(out)), pos
            continue
        j = i
        while j < n and src[j] not in ' \t\r\n()[];"':
            j += 1
        yield src[i:j], pos
        col += j - i
        i = j


def _atom(tok: str, pos) -> Any:
    if tok == "#t":
        return True
    if tok == "#f":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    s = Symbol(tok)
    s.pos = pos
    return s


def parse(src: str) -> List[Any]:
    """Read all top-level forms."""
    forms: List[Any] = []
    stack: List[SList] = []
    closer: List[str] = []
    pend: List[int] = [0]   # pending quote count per nesting level

    def _sym(name, pos):
        s = Symbol(name)
        s.pos = pos
        return s

    def wrap_quotes(v, pos):
        for _ in range(pend[-1]):
            q = SList([_sym("quote", pos), v])
            q.pos = pos
            v = q
        pend[-1] = 0
        return v

    for tok, pos in _tokenize(src):
        if tok == "'":
            pend[-1] += 1
            continue
        if tok in ("(", "["):
            lst = SList()
            lst.pos = pos
            if tok == "[":
                lst.append(_sym("vector", pos))
            stack.append(lst)
            closer.append(")" if tok == "(" else "]")
            pend.append(0)
            continue
        if tok in (")", "]"):
            if not stack:
                raise SchemeError(f"unexpected '{tok}'", pos)
            if closer[-1] != tok:
                raise SchemeError(
                    f"mismatched '{tok}' (expected '{closer[-1]}')", pos)
            lst = stack.pop()
            closer.pop()
            pend.pop()
            v = wrap_quotes(lst, lst.pos)
            if stack:
                stack[-1].append(v)
            else:
                forms.append(v)
            continue
        v = _atom(tok, pos) if isinstance(tok, str) else tok[1]
        v = wrap_quotes(v, pos)
        if stack:
            stack[-1].append(v)
        else:
            forms.append(v)
    if stack:
        raise SchemeError("unclosed '('", stack[-1].pos)
    return forms


# ---------------------------------------------------------------------------
# environments + evaluator
# ---------------------------------------------------------------------------

class Env(dict):
    __slots__ = ("parent",)

    def __init__(self, parent: Optional["Env"] = None, init=None):
        super().__init__(init or {})
        self.parent = parent

    def lookup(self, name: str, pos=None):
        e = self
        while e is not None:
            if name in e:
                return e[name]
            e = e.parent
        raise SchemeError(f"unbound variable '{name}'", pos)

    def assign(self, name: str, value, pos=None):
        e = self
        while e is not None:
            if name in e:
                e[name] = value
                return
            e = e.parent
        raise SchemeError(f"set! of unbound variable '{name}'", pos)


class Lambda:
    __slots__ = ("params", "rest", "body", "env", "name")

    def __init__(self, params, rest, body, env, name="lambda"):
        self.params = params
        self.rest = rest
        self.body = body
        self.env = env
        self.name = name

    def __call__(self, *args):
        if self.rest is None and len(args) != len(self.params) or (
                self.rest is not None and len(args) < len(self.params)):
            raise SchemeError(
                f"{self.name}: expected "
                f"{'at least ' if self.rest else ''}{len(self.params)} "
                f"args, got {len(args)}")
        env = Env(self.env)
        for p, a in zip(self.params, args):
            env[p] = a
        if self.rest is not None:
            env[self.rest] = list(args[len(self.params):])
        out = None
        for f in self.body:
            out = _eval(f, env)
        return out


def _pos(form) -> Optional[Tuple[int, int]]:
    return getattr(form, "pos", None)


def _params(spec, pos):
    """Parse a lambda parameter list: (a b c) or (a . rest) or sym."""
    if isinstance(spec, Symbol):
        return [], str(spec)
    if not isinstance(spec, list):
        raise SchemeError("bad parameter list", pos)
    names = []
    rest = None
    it = list(spec)
    i = 0
    while i < len(it):
        p = it[i]
        if str(p) == ".":
            rest = str(it[i + 1])
            break
        names.append(str(p))
        i += 1
    return names, rest


def _eval(form, env: Env):
    # atoms
    if isinstance(form, Symbol):
        return env.lookup(str(form), _pos(form))
    if not isinstance(form, list):
        return form
    if not form:
        raise SchemeError("cannot evaluate ()", _pos(form))
    head = form[0]
    hname = str(head) if isinstance(head, Symbol) else None

    # -- special forms ------------------------------------------------------
    if hname in ("quote", "define", "set!", "lambda", "let", "let*",
                 "letrec", "sequence", "lambda-shape", "define-shape"):
        # arity floor so malformed forms report a positioned SchemeError
        # (like every other script error) instead of a raw IndexError
        need = {"set!": 3, "lambda": 3, "let": 3, "let*": 3, "letrec": 3,
                "lambda-shape": 3, "define-shape": 3}.get(hname, 2)
        if len(form) < need:
            raise SchemeError(f"{hname}: missing arguments", _pos(form))
    if hname == "quote":
        return form[1]
    if hname == "if":
        if len(form) not in (3, 4):
            raise SchemeError("if: bad arity", _pos(form))
        c = _eval(form[1], env)
        if c is not False:
            return _eval(form[2], env)
        return _eval(form[3], env) if len(form) == 4 else None
    if hname == "cond":
        for clause in form[1:]:
            if not isinstance(clause, list) or not clause:
                raise SchemeError("cond: bad clause", _pos(form))
            if str(clause[0]) == "else":
                out = None
            else:
                out = _eval(clause[0], env)
                if out is False:
                    continue
            # a test-only clause, (cond (x)), returns the test's value
            for f in clause[1:]:
                out = _eval(f, env)
            return out
        return None
    if hname == "define":
        target = form[1]
        if isinstance(target, list):          # (define (f a b) body...)
            name = str(target[0])
            names, rest = _params(SList(target[1:]), _pos(form))
            env[name] = Lambda(names, rest, form[2:], env, name)
        else:
            env[str(target)] = (_eval(form[2], env) if len(form) > 2
                                else None)
        return None
    if hname == "set!":
        env.assign(str(form[1]), _eval(form[2], env), _pos(form))
        return None
    if hname == "lambda":
        names, rest = _params(form[1], _pos(form))
        return Lambda(names, rest, form[2:], env)
    if hname in ("let", "let*", "letrec"):
        bindings = form[1]
        # named let is not used by the examples; reject it clearly
        if isinstance(bindings, Symbol):
            raise SchemeError("named let is not supported", _pos(form))
        new = Env(env)
        if hname == "let":
            vals = [_eval(b[1], env) for b in bindings]
            for b, v in zip(bindings, vals):
                new[str(b[0])] = v
        else:                                 # let* / letrec
            for b in bindings:
                new[str(b[0])] = _eval(b[1], new)
        out = None
        for f in form[2:]:
            out = _eval(f, new)
        return out
    if hname == "begin":
        out = None
        for f in form[1:]:
            out = _eval(f, env)
        return out
    if hname == "and":
        out = True
        for f in form[1:]:
            out = _eval(f, env)
            if out is False:
                return False
        return out
    if hname == "or":
        for f in form[1:]:
            out = _eval(f, env)
            if out is not False:
                return out
        return False
    if hname == "sequence":
        # libfive's shape-threading macro: (sequence x (f a...) (g b...))
        # = (g (f x a...) b...)
        val = _eval(form[1], env)
        for step in form[2:]:
            if not isinstance(step, list) or not step:
                raise SchemeError("sequence: each step must be a call",
                                  _pos(step) or _pos(form))
            fn = _eval(step[0], env)
            args = [_eval(a, env) for a in step[1:]]
            if not callable(fn):
                raise SchemeError("sequence: step is not callable",
                                  _pos(step))
            val = fn(val, *args)
        return val
    if hname == "lambda-shape":
        # (lambda-shape (x y z) body) -> the shape f(x,y,z), built by
        # evaluating the body over the coordinate trees
        names = [str(s) for s in form[1]]
        if len(names) != 3:
            raise SchemeError("lambda-shape: needs (x y z)", _pos(form))
        new = Env(env)
        for nm, t in zip(names, (_tree.x(), _tree.y(), _tree.z())):
            new[nm] = t
        out = None
        for f in form[2:]:
            out = _eval(f, new)
        return _as_shape(out, _pos(form))
    if hname == "remap-shape":
        # (remap-shape (shape x y z) ex ey ez) — libfive's coordinate
        # remap: the shape evaluated at the remapped coordinates
        spec = form[1]
        if not isinstance(spec, list) or len(spec) != 4 or len(form) != 5:
            raise SchemeError("remap-shape: (remap-shape (s x y z) "
                              "ex ey ez)", _pos(form))
        s = _as_shape(_eval(spec[0], env), _pos(form))
        new = Env(env)
        for nm, t in zip(spec[1:], (_tree.x(), _tree.y(), _tree.z())):
            new[str(nm)] = t
        coords = [_eval(f, new) for f in form[2:5]]
        coords = [_tree.Tree.wrap(c) for c in coords]
        return s.remap(*coords)
    if hname == "var":
        # (var name value [lo hi]) — a named free parameter (the free
        # variables the reference interpreter extracts from script
        # results, gui/interpreter.cpp:125-148).  Defines ``name`` in the
        # environment, records slider metadata for the viewer, and
        # returns the param node (so (circle (var r 0.5)) also works).
        if len(form) not in (3, 5) or not isinstance(form[1], Symbol):
            raise SchemeError("var: (var name value [lo hi])", _pos(form))
        vname = str(form[1])
        value = float(_eval(form[2], env))
        if len(form) == 5:
            lo, hi = float(_eval(form[3], env)), float(_eval(form[4], env))
        else:  # default slider range around the value
            span = max(abs(value), 1.0)
            lo, hi = value - span, value + span
        node = _tree.var(vname, value)
        env[vname] = node
        try:
            hook = env.lookup("__var-hook__")
        except SchemeError:
            hook = None
        if hook is not None:
            hook(vname, value, lo, hi)
        return node
    if hname == "define-shape":
        # (define-shape (name x y z) body) — libfive stdlib idiom
        name = str(form[1][0])
        lam = SList([Symbol("lambda-shape"), SList(form[1][1:])]
                    + list(form[2:]))
        lam.pos = _pos(form) or (0, 0)
        env[name] = _eval(lam, env)
        return None

    # -- application ---------------------------------------------------------
    fn = _eval(head, env)
    if not callable(fn):
        raise SchemeError(f"not callable: {fn!r}", _pos(form))
    args = [_eval(a, env) for a in form[1:]]
    try:
        return fn(*args)
    except SchemeError:
        raise
    except Exception as e:                    # surface position like the
        raise SchemeError(f"{e}", _pos(form))  # reference's error pane


def _as_shape(v, pos=None) -> Tree:
    if isinstance(v, Tree):
        return v
    if isinstance(v, (int, float)):
        return _tree.const(float(v))
    raise SchemeError(f"expected a shape, got {type(v).__name__}", pos)


# ---------------------------------------------------------------------------
# builtins: numbers (Tree-dispatching) + lists
# ---------------------------------------------------------------------------

def _is_tree(v) -> bool:
    return isinstance(v, Tree)


def _fold(fn, args, unit=None):
    if not args:
        if unit is None:
            raise SchemeError("needs at least one argument")
        return unit
    out = args[0]
    for a in args[1:]:
        out = fn(out, a)
    return out


def _add(*a):
    return _fold(lambda p, q: p + q, a, 0)


def _mul(*a):
    return _fold(lambda p, q: p * q, a, 1)


def _sub(*a):
    if len(a) == 1:
        return -a[0]
    return _fold(lambda p, q: p - q, a)


def _div(*a):
    if len(a) == 1:
        return 1 / a[0] if not _is_tree(a[0]) else _tree.recip(a[0])
    return _fold(lambda p, q: p / q, a)


def _minmax(tfn, nfn):
    def f(*a):
        if any(_is_tree(v) for v in a):
            return _fold(tfn, a)
        return nfn(a)
    return f


def _un(tfn, nfn):
    def f(v):
        return tfn(v) if _is_tree(v) else nfn(v)
    return f


def _atan(*a):
    if len(a) == 1:
        return _tree.atan(a[0]) if _is_tree(a[0]) else math.atan(a[0])
    if len(a) == 2:
        if _is_tree(a[0]) or _is_tree(a[1]):
            return _tree.atan2(a[0], a[1])
        return math.atan2(a[0], a[1])
    raise SchemeError("atan: 1 or 2 arguments")


def _expt(b, e):
    if _is_tree(b) or _is_tree(e):
        return _tree.pow_(b, e)
    return b ** e


def _cmp(op):
    def f(*a):
        return all(op(a[i], a[i + 1]) for i in range(len(a) - 1))
    return f


def _iota(n, start=0, step=1):
    n = int(n)
    return [start + i * step for i in range(n)]


_NUM_BUILTINS: Dict[str, Any] = {
    "+": _add, "-": _sub, "*": _mul, "/": _div,
    "min": _minmax(_tree.minimum, min),
    "max": _minmax(_tree.maximum, max),
    "sqrt": _un(_tree.sqrt, math.sqrt),
    "square": _un(_tree.square, lambda v: v * v),
    "sin": _un(_tree.sin, math.sin), "cos": _un(_tree.cos, math.cos),
    "tan": _un(_tree.tan, math.tan),
    "asin": _un(_tree.asin, math.asin),
    "acos": _un(_tree.acos, math.acos),
    "atan": _atan,
    "exp": _un(_tree.exp, math.exp), "log": _un(_tree.log, math.log),
    "abs": _un(_tree.abs_, abs),
    "expt": _expt, "pow": _expt,
    "round": lambda v: float(np.round(v)), "floor": math.floor,
    "ceiling": math.ceil, "truncate": math.trunc,
    "modulo": lambda a, b: a % b,       # floor-division remainder
    "remainder": math.fmod,             # truncated-division remainder
    "quotient": lambda a, b: math.trunc(a / b),   # truncated division
    "=": _cmp(lambda a, b: a == b), "<": _cmp(lambda a, b: a < b),
    ">": _cmp(lambda a, b: a > b), "<=": _cmp(lambda a, b: a <= b),
    ">=": _cmp(lambda a, b: a >= b),
    "not": lambda v: v is False,
    "number?": lambda v: isinstance(v, (int, float)),
    "shape?": _is_tree,
    "pi": math.pi,                       # value, not function
    # lists / vectors (both are Python lists here)
    "vector": lambda *a: list(a),
    "list": lambda *a: list(a),
    "car": lambda l: l[0], "cdr": lambda l: list(l[1:]),
    "cons": lambda a, l: [a] + list(l),
    "length": len, "reverse": lambda l: list(reversed(l)),
    "append": lambda *ls: sum((list(l) for l in ls), []),
    "list-ref": lambda l, i: l[int(i)],
    "null?": lambda l: isinstance(l, list) and not l,
    "map": lambda f, *ls: [f(*vs) for vs in zip(*ls)],
    "for-each": lambda f, *ls: [f(*vs) for vs in zip(*ls)] and None,
    "apply": lambda f, *a: f(*(list(a[:-1]) + list(a[-1]))),
    "iota": _iota,
    "string-append": lambda *s: "".join(s),
    "number->string": lambda v, *_: repr(v),
}


# ---------------------------------------------------------------------------
# builtins: the libfive shape stdlib surface
# ---------------------------------------------------------------------------

def _num(v, name: str = "argument"):
    """Scalar coercion that lets named parameters (frontend var() nodes)
    flow into shape arguments: Trees pass through (shapes.py builds with
    operator overloading, so a Tree radius/offset/angle is as good as a
    float), everything else must be a real number."""
    if isinstance(v, Tree):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        raise SchemeError(f"{name}: expected a number or a var, got {v!r}")


def _vec(v, lo: int, hi: int, name: str) -> List[float]:
    if not isinstance(v, list) or not (lo <= len(v) <= hi) or any(
            not isinstance(c, (int, float, Tree)) for c in v):
        raise SchemeError(f"{name}: expected a [{lo}..{hi}]-component "
                          f"vector, got {v!r}")
    return [_num(c, name) for c in v]


def _pt2(v, name) -> Tuple[float, float]:
    c = _vec(v, 2, 3, name)
    return c[0], c[1]


def _pt3(v, name) -> Tuple[float, float, float]:
    c = _vec(v, 2, 3, name)
    return c[0], c[1], (c[2] if len(c) > 2 else 0.0)


def _sh_circle(r, center=None):
    cx, cy = _pt2(center, "circle") if center is not None else (0.0, 0.0)
    return _shapes.circle(_num(r, 'circle'), cx, cy)


def _sh_ring(ro, ri, center=None):
    cx, cy = _pt2(center, "ring") if center is not None else (0.0, 0.0)
    return _shapes.difference(_shapes.circle(_num(ro, 'ring'), cx, cy),
                              _shapes.circle(_num(ri, 'ring'), cx, cy))


def _sh_sphere(r, center=None):
    cx, cy, cz = (_pt3(center, "sphere") if center is not None
                  else (0.0, 0.0, 0.0))
    return _shapes.sphere(_num(r, 'sphere'), cx, cy, cz)


def _sh_rectangle(a, b):
    ax, ay = _pt2(a, "rectangle")
    bx, by = _pt2(b, "rectangle")
    return _shapes.rectangle(ax, bx, ay, by)


def _sh_box(a, b):
    ax, ay, az = _pt3(a, "box")
    bx, by, bz = _pt3(b, "box")
    return _shapes.box(ax, bx, ay, by, az, bz)


def _sh_cylinder_z(r, h, base=None):
    cx, cy, cz = (_pt3(base, "cylinder-z") if base is not None
                  else (0.0, 0.0, 0.0))
    return _shapes.cylinder_z(_num(r, 'cylinder-z'), cz,
                              cz + _num(h, 'cylinder-z'), cx, cy)


def _sh_cone_z(r, h, base=None):
    cx, cy, cz = (_pt3(base, "cone-z") if base is not None
                  else (0.0, 0.0, 0.0))
    xt, yt, zt = _tree.x() - cx, _tree.y() - cy, _tree.z() - cz
    r, h = _num(r, 'cone-z'), _num(h, 'cone-z')
    side = _tree.sqrt(_tree.square(xt) + _tree.square(yt)) * (
        h) / r + zt - h
    return _shapes.intersection(side, -zt)


def _sh_pyramid_z(a, b, zmin, h):
    """(pyramid-z [xmin ymin] [xmax ymax] zmin height): rectangular
    pyramid tapering to the rectangle's center at zmin+height."""
    ax, ay = _pt2(a, "pyramid-z")
    bx, by = _pt2(b, "pyramid-z")
    zmin, h = _num(zmin, 'pyramid-z'), _num(h, 'pyramid-z')
    cx, cy = (ax + bx) / 2, (ay + by) / 2
    # taper the box cross-section with height: at z=zmin full size, at
    # z=zmin+h zero size
    t = (_tree.z() - zmin) / h                 # 0 at base, 1 at apex
    hx, hy = (bx - ax) / 2, (by - ay) / 2
    sx = abs(_tree.x() - cx) - hx * (1.0 - t)
    sy = abs(_tree.y() - cy) - hy * (1.0 - t)
    return _shapes.intersection(_tree.maximum(sx, sy),
                                zmin - _tree.z(), _tree.z() - (zmin + h))


def _sh_move(s, d):
    dx, dy, dz = _pt3(d, "move")
    return _shapes.move(_as_shape(s), dx, dy, dz)


def _sh_scale_xyz(s, f, center=None):
    sx, sy, sz = _pt3(f, "scale-xyz")
    sz = sz if sz != 0.0 else 1.0
    cx, cy, cz = (_pt3(center, "scale-xyz") if center is not None
                  else (0.0, 0.0, 0.0))
    s = _as_shape(s)
    return s.remap((_tree.x() - cx) / sx + cx,
                   (_tree.y() - cy) / sy + cy,
                   (_tree.z() - cz) / sz + cz)


def _axis_scale(axis: int):
    def f(s, factor, c0=0.0):
        s = _as_shape(s)
        factor, c0 = _num(factor, 'scale'), _num(c0, 'scale')
        coords = [_tree.x(), _tree.y(), _tree.z()]
        coords[axis] = (coords[axis] - c0) / factor + c0
        return s.remap(*coords)
    return f


def _axis_reflect(axis: int):
    def f(s, c0=0.0):
        s = _as_shape(s)
        c0 = _num(c0, 'reflect')
        coords = [_tree.x(), _tree.y(), _tree.z()]
        coords[axis] = 2.0 * c0 - coords[axis]
        return s.remap(*coords)
    return f


def _swap_reflect(a: int, b: int):
    def f(s):
        s = _as_shape(s)
        coords = [_tree.x(), _tree.y(), _tree.z()]
        coords[a], coords[b] = coords[b], coords[a]
        return s.remap(*coords)
    return f


def _rot(fn):
    def f(s, angle, center=None):
        s = _as_shape(s)
        if center is None:
            return fn(s, _num(angle, 'rotate'))
        cx, cy, cz = _pt3(center, "rotate")
        s = _shapes.move(s, -cx, -cy, -cz)
        return _shapes.move(fn(s, _num(angle, 'rotate')), cx, cy, cz)
    return f


def _sh_union(*s):
    return _shapes.union(*[_as_shape(v) for v in s])


def _sh_intersection(*s):
    return _shapes.intersection(*[_as_shape(v) for v in s])


def _sh_difference(a, *rest):
    out = _as_shape(a)
    for r in rest:
        out = _shapes.difference(out, _as_shape(r))
    return out


def _sh_extrude_z(s, zmin, zmax):
    return _shapes.extrude_z(_as_shape(s), _num(zmin, 'extrude-z'),
                             _num(zmax, 'extrude-z'))


def _sh_offset(s, o):
    return _shapes.offset(_as_shape(s), _num(o, 'offset'))


def _sh_blend(a, b, m):
    return _shapes.blend(_as_shape(a), _as_shape(b), _num(m, 'blend'))


def _sh_text(txt, pos=None):
    px, py = _pt2(pos, "text") if pos is not None else (0.0, 0.0)
    return _font.text(str(txt), px, py)


def _sh_array_axis(axis: int):
    def f(s, n, d):
        s = _as_shape(s)
        out = s
        delta = [0.0, 0.0, 0.0]
        for i in range(1, int(n)):
            delta[axis] = i * float(d)
            out = _shapes.union(out, _shapes.move(s, *delta))
        return out
    return f


def _sh_array_xy(s, nx, ny, d):
    dx, dy = _pt2(d, "array-xy")
    row = _sh_array_axis(0)(s, nx, dx)
    return _sh_array_axis(1)(row, ny, dy)


def _sh_array_polar(s, n, center=None):
    s = _as_shape(s)
    cx, cy = _pt2(center, "array-polar") if center is not None else (0.0,
                                                                     0.0)
    out = s
    for i in range(1, int(n)):
        r = _rot(_shapes.rotate_z)(s, 2.0 * math.pi * i / int(n),
                                   [cx, cy, 0.0])
        out = _shapes.union(out, r)
    return out


def _sh_revolve_y(s):
    """Revolve a 2D (xy) shape about the y axis.  The radius remap
    covers x >= 0; the union with the mirrored remap covers shapes drawn
    on negative x, like libfive's revolve-y."""
    s = _as_shape(s)
    r = _tree.sqrt(_tree.square(_tree.x()) + _tree.square(_tree.z()))
    return _shapes.union(s.remap(r, _tree.y(), _tree.z()),
                         s.remap(-r, _tree.y(), _tree.z()))


def _sh_loft(a, b, zmin, zmax):
    """Linear field interpolation from shape a at zmin to shape b at
    zmax, clipped to the slab."""
    a, b = _as_shape(a), _as_shape(b)
    zmin, zmax = float(zmin), float(zmax)
    t = (_tree.z() - zmin) / (zmax - zmin)
    t = _tree.maximum(0.0, _tree.minimum(1.0, t))
    f = a * (1.0 - t) + b * t
    return _shapes.intersection(f, zmin - _tree.z(), _tree.z() - zmax)


def _sh_morph(a, b, m):
    a, b = _as_shape(a), _as_shape(b)
    m = float(m)
    return a * (1.0 - m) + b * m


def _sym(axis: int):
    def f(s):
        s = _as_shape(s)
        coords = [_tree.x(), _tree.y(), _tree.z()]
        coords[axis] = abs(coords[axis])
        return s.remap(*coords)
    return f


_SHAPE_BUILTINS: Dict[str, Any] = {
    "circle": _sh_circle,
    "ring": _sh_ring,
    "sphere": _sh_sphere,
    "rectangle": _sh_rectangle,
    "box": _sh_box,
    "cube": _sh_box,
    "cylinder-z": _sh_cylinder_z,
    "cylinder": _sh_cylinder_z,
    "cone-z": _sh_cone_z,
    "pyramid-z": _sh_pyramid_z,
    "torus-z": lambda ro, ri: _shapes.torus_z(_num(ro), _num(ri)),
    "torus": lambda ro, ri: _shapes.torus_z(_num(ro), _num(ri)),
    "gyroid": lambda p=1.0, t=0.1: _shapes.gyroid(_num(p), _num(t)),
    "half-space-z": lambda z0=0.0: _shapes.half_space_z(_num(z0)),
    "union": _sh_union,
    "intersection": _sh_intersection,
    "difference": _sh_difference,
    "inverse": lambda s: _shapes.inverse(_as_shape(s)),
    "offset": _sh_offset,
    "blend": _sh_blend,
    "shell": lambda s, o: _shapes.difference(
        _as_shape(s), _shapes.offset(_as_shape(s),
                                     -abs(_num(o, "shell")))),
    "move": _sh_move,
    "translate": _sh_move,
    "scale-x": _axis_scale(0), "scale-y": _axis_scale(1),
    "scale-z": _axis_scale(2),
    "scale-xyz": _sh_scale_xyz,
    "reflect-x": _axis_reflect(0), "reflect-y": _axis_reflect(1),
    "reflect-z": _axis_reflect(2),
    "reflect-xy": _swap_reflect(0, 1), "reflect-yz": _swap_reflect(1, 2),
    "reflect-xz": _swap_reflect(0, 2),
    "rotate-x": _rot(_shapes.rotate_x), "rotate-y": _rot(_shapes.rotate_y),
    "rotate-z": _rot(_shapes.rotate_z),
    "extrude-z": _sh_extrude_z,
    "extrude": _sh_extrude_z,
    "text": _sh_text,
    "array-x": _sh_array_axis(0), "array-y": _sh_array_axis(1),
    "array-z": _sh_array_axis(2),
    "array-xy": _sh_array_xy,
    "array-polar": _sh_array_polar,
    "revolve-y": _sh_revolve_y,
    "loft": _sh_loft,
    "morph": _sh_morph,
    "symmetric-x": _sym(0), "symmetric-y": _sym(1), "symmetric-z": _sym(2),
}


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

@dataclass
class ScriptResult:
    """Everything a viewer needs from one script evaluation, mirroring the
    reference interpreter's outputs (shapes + settings,
    gui/interpreter.cpp:125-164 + gui/examples/architecture.io:1-3)."""
    shapes: List[Tree] = field(default_factory=list)
    bounds: Optional[Tuple[Tuple[float, float, float],
                           Tuple[float, float, float]]] = None
    quality: Optional[float] = None
    resolution: Optional[float] = None
    env: Optional[Env] = None
    # (var name value [lo hi]) declarations: name -> (value, lo, hi) —
    # the free-variable extraction of gui/interpreter.cpp:125-148, plus
    # slider ranges for the viewer
    vars: Dict[str, Tuple[float, float, float]] = field(default_factory=dict)


def _global_env(result: ScriptResult) -> Env:
    env = Env(init=dict(_NUM_BUILTINS))
    env.update(_SHAPE_BUILTINS)

    def set_bounds(lo, hi):
        result.bounds = (tuple(_pt3(lo, "set-bounds!")),
                         tuple(_pt3(hi, "set-bounds!")))

    def set_quality(q):
        result.quality = float(q)

    def set_resolution(r):
        result.resolution = float(r)

    env["set-bounds!"] = set_bounds
    env["set-quality!"] = set_quality
    env["set-resolution!"] = set_resolution
    env["__var-hook__"] = (
        lambda name, value, lo, hi: result.vars.__setitem__(
            name, (value, lo, hi)))
    return env


def run_string(src: str) -> ScriptResult:
    """Evaluate a script; collect every top-level shape value (the
    reference collects shapes from evaluated results the same way,
    gui/interpreter.cpp:125-164)."""
    result = ScriptResult()
    env = _global_env(result)
    result.env = env
    for form in parse(src):
        v = _eval(form, env)
        # a bare top-level (var ...) returns its param node — that is a
        # declaration, not a scene shape
        if isinstance(v, Tree) and v.op != _tree.PARAM:
            result.shapes.append(v)
    return result


def run_file(path: str) -> ScriptResult:
    with open(path, "r") as f:
        return run_string(f.read())
