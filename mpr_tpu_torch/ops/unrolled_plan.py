"""The statement plan of the generated float, interval and deriv kernels.

``ops/unrolled_eval.py`` walks a tape's clauses once over a C backend and
records each float32 (or bool) operation as a :class:`Stmt`: its name, its
operation and its operands (statement names, float32 literals, or for a
load the input, immediate or shared slot it reads), and the clause that
made it.  Rewrites (``_Folding``) happen before the record, so a statement
rounds exactly as the plain PyTorch walk's operation does.  This module
decides, once per tape on the host, in what order and where the kernel
runs those statements:

  * :func:`schedule`: a register-pressure order.  Depth-first from the
    outputs over the clauses, each clause right after the clauses it
    reads, the one that needs more registers (Sethi–Ullman's count on
    the DAG) before the lighter one, a clause's statements together.  In
    tape order a value lives from its clause to its last reader: up to
    170 float values at once on the chip cells' tapes, and 500 of the
    dual numbers' (four a clause), which ptxas must keep in registers or
    spill.  Depth first, a dozen or so float values are
    (:func:`live_peak`), about 40 of the dual numbers'.  The pass drops,
    merges and reassociates nothing: a clause no output reads goes right
    after the last clause it reads.
  * :func:`split`: a launch of fewer lanes than one wave of the card runs
    each lane's tape serially in one thread, the card nearly empty.  The
    split form cuts the result's clause DAG below its top clauses into
    subtrees and packs them onto ``P`` warps, longest first onto the
    least-loaded warp, warp 0 also holding the top.  It cuts the largest
    subtree again and again and keeps the cut whose longest warp has the
    fewest statements.  Each warp computes its subtrees' clauses for 32
    lanes (a statement two subtrees share is computed in each) and leaves
    their values in shared memory; warp 0 then runs the top clauses from
    them.
  * :func:`replay`, :func:`replay_split`: the ordered statements in plain
    PyTorch, each part with only its own statements, the top with only
    its own and the parts' results: what the CPU tests hold against the
    evaluator's plain walk (``UnrolledEval.plain``) bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import transcendental as tc


@dataclass(frozen=True)
class Stmt:
    """One statement: ``name = op(args)`` of type ``ty`` ("float" or
    "bool"), made by clause ``clause`` (-1: an input load).  ``args`` are
    statement names (str) and float32 literals (float); a load's are one
    int: the input (``"in"``), the clause of the immediate (``"imm"``) or
    the shared slot of a part's result (``"part"``)."""
    name: str
    ty: str
    op: str
    args: tuple
    clause: int


LOADS = ("in", "imm", "part")
# part results a split block holds in shared memory at most (32 floats
# each: 48 KB of static shared memory)
MAX_SLOTS = 384


def operands(s: Stmt):
    """The statement names ``s`` reads, each once, in order."""
    return list(dict.fromkeys(a for a in s.args if isinstance(a, str)))


@dataclass
class Program:
    """A kernel's statements in walk order and its outputs (statement
    names or float32 literals)."""
    stmts: list
    outs: tuple

    def __post_init__(self):
        self.by_name = {s.name: s for s in self.stmts}


# ---------------------------------------------------------------------------
# Order and pressure
# ---------------------------------------------------------------------------

def schedule(stmts, outs):
    """``stmts`` (in walk order) reordered depth-first over their clauses
    from the outputs' clauses: each clause right after the clauses it
    reads, the one of the larger Sethi–Ullman need first (ties: the
    earlier clause), its statements together in walk order (an interval
    clause's bounds share their products and tests, a dual number's value
    and partials their operands), each input load just before its first
    reader.  A clause's width is its statements read elsewhere (a float
    clause has one, an interval clause two, a dual number's one to four:
    a partial that is a literal holds no register).  A clause no output
    reaches follows the last clause it reads.  Returns the statements,
    each once."""
    owner = {s.name: s.clause for s in stmts}
    of_clause, loads = {}, {}
    for s in stmts:
        if s.clause == -1:
            loads[s.name] = s
        else:
            of_clause.setdefault(s.clause, []).append(s)
    clauses = sorted(of_clause)
    reads = {c: [a for s in of_clause[c] for a in operands(s)]
             for c in clauses}
    kids = {c: sorted({owner[a] for a in reads[c]} - {c, -1})
            for c in clauses}
    read_out = {a for c in clauses for a in reads[c] if owner[a] != c}
    read_out |= {o for o in outs if isinstance(o, str)}
    need = {}
    for c in clauses:
        width = max(1, sum(s.name in read_out for s in of_clause[c]))
        ks = sorted((need[k] for k in kids[c]), reverse=True)
        need[c] = max([width] + [k + j for j, k in enumerate(ks)])
    order, done = [], {}

    def emit(c):
        for a in reads[c]:
            if owner[a] == -1 and a not in done:
                order.append(loads[a])
                done[a] = len(order)
        for st in of_clause[c]:
            order.append(st)
        done[c] = len(order)
    roots = dict.fromkeys(owner[o] for o in outs
                          if isinstance(o, str) and owner[o] >= 0)
    for r in roots:
        if r in done:
            continue
        done[r] = None
        stack = [(r, iter(sorted(kids[r], key=lambda k: (-need[k], k))))]
        while stack:
            c, it = stack[-1]
            for k in it:
                if k not in done:
                    done[k] = None
                    stack.append((k, iter(sorted(
                        kids[k], key=lambda q: (-need[q], q)))))
                    break
            else:
                stack.pop()
                emit(c)
    after = {}
    for c in clauses:
        if c not in done:
            done[c] = max((done[k] for k in kids[c] + [
                a for a in reads[c] if owner[a] == -1 and a in done]),
                default=0)
            after.setdefault(done[c], []).append(c)
    if after:
        base, order = order, []
        for c in after.pop(0, ()):
            emit(c)
        for i, st in enumerate(base):
            order.append(st)
            for c in after.get(i + 1, ()):
                emit(c)
    rest = [s for n, s in loads.items() if n not in done]
    return rest + order


def live_peak(order, outs) -> int:
    """Most values live at once between two statements of ``order``: made
    before the point and read after it (an output until the end).  The
    input loads are left out: the lane's coordinates are read throughout
    the tape in any order."""
    last = {}
    for i, s in enumerate(order):
        for a in operands(s):
            last[a] = i
    for o in outs:
        if isinstance(o, str):
            last[o] = len(order)
    delta = [0] * (len(order) + 1)
    for i, s in enumerate(order):
        if s.op != "in" and last.get(s.name, i) > i:
            delta[i] += 1
            delta[last[s.name]] -= 1
    peak = run = 0
    for d in delta:
        run += d
        peak = max(peak, run)
    return peak


def float_ops(prog: Program) -> int:
    """Float operations a lane: the float statements other than loads (a
    math-library call counts one)."""
    return sum(s.ty == "float" and s.op not in LOADS for s in prog.stmts)


def lane_invariant(stmts) -> set:
    """Names of the statements every lane computes alike: immediate loads
    and what only they and literals feed (a K-lane kernel writes them once
    for its K lanes)."""
    out = set()
    for s in stmts:
        if s.op == "imm" or (s.op not in LOADS
                             and all(a in out for a in operands(s))):
            out.add(s.name)
    return out


# ---------------------------------------------------------------------------
# The split form
# ---------------------------------------------------------------------------

@dataclass
class Part:
    """One warp's share: ``order`` (scheduled) computes the clauses of
    ``roots`` (and what they read); ``outs`` are (name, shared slot) of
    the values the top reads."""
    roots: list
    order: list
    outs: list = field(default_factory=list)


@dataclass
class Split:
    """The split form of a program over ``P`` warps: ``parts`` (some may
    be empty), ``top`` (scheduled; its ``part`` loads read the parts'
    slots) and the program's outputs."""
    parts: list
    top: list
    outs: tuple
    top_clauses: list
    n_slots: int

    @property
    def warps(self) -> int:
        """Warps a block runs: up to the last one with work (at least 1)."""
        used = [k for k, p in enumerate(self.parts) if p.order]
        return max(used, default=0) + 1

    def duplicated(self) -> int:
        """Statements (input loads aside) computed in more than one part."""
        seen, dup = set(), set()
        for p in self.parts:
            for s in p.order:
                if s.op == "in":
                    continue
                (dup if s.name in seen else seen).add(s.name)
        return len(dup)

    def longest(self) -> int:
        """Statements of the longest warp (warp 0 with the top)."""
        lens = [len(p.order) for p in self.parts] or [0]
        lens[0] += len(self.top)
        return max(lens)


def split(prog: Program, P: int) -> Split:
    """Cut ``prog`` among ``P`` warps (module doc)."""
    stmts, outs = prog.stmts, prog.outs
    by = prog.by_name
    owner = {s.name: s.clause for s in stmts}
    of_clause = {}
    for s in stmts:
        of_clause.setdefault(s.clause, []).append(s)
    children = {c: sorted({owner[a] for s in ss for a in operands(s)}
                          - {c, -1}) for c, ss in of_clause.items()}

    cl_of = {}

    def closure(c):
        if c not in cl_of:
            seen, todo = set(), [c]
            while todo:
                q = todo.pop()
                if q not in seen:
                    seen.add(q)
                    todo += children.get(q, ())
            cl_of[c] = frozenset(seen)
        return cl_of[c]

    def size(c):
        return sum(len(of_clause[k]) for k in closure(c))

    def n_of(cls):
        return sum(len(of_clause[c]) for c in cls)

    def pack(top, frontier):
        """Longest-first onto the least-loaded warp (warp 0 starts with
        the top): (roots, clauses, statements) a warp."""
        bins = [[[], set(), 0] for _ in range(P)]
        bins[0][2] = top_n = n_of(top)
        for f in sorted(frontier, key=lambda c: (-size(c), c)):
            b = min(bins, key=lambda b: b[2])
            b[0].append(f)
            b[1] |= closure(f)
            b[2] = n_of(b[1]) + (top_n if b is bins[0] else 0)
        return bins

    read_by = {a for s in stmts for a in operands(s) if owner[a] != s.clause}
    read_by |= {o for o in outs if isinstance(o, str)}
    outs_of = {c: [s.name for s in ss if s.name in read_by]
               for c, ss in of_clause.items()}

    def expand(top, frontier, f):
        top, frontier = top + [f], [c for c in frontier if c != f]
        frontier += [c for c in children[f]
                     if c not in top and c not in frontier]
        return top, frontier
    out_owners = list(dict.fromkeys(
        owner[o] for o in outs if isinstance(o, str) and owner[o] >= 0))
    live = set().union(*(closure(c) for c in out_owners))
    top, frontier = [], list(out_owners)
    # cut the largest subtree, again and again (up to 4P top clauses, and
    # as many part results as shared memory holds): the cut whose longest
    # warp is shortest
    best = None
    while True:
        bins = pack(top, frontier)
        longest = max(b[2] for b in bins)
        if best is None or longest < best[0]:
            best = (longest, top, frontier, bins)
        cand = [f for f in frontier if children.get(f)]
        if not cand or len(top) >= 4 * P:
            break
        top2, frontier2 = expand(top, frontier,
                                 max(cand, key=lambda c: (size(c), -c)))
        if sum(len(outs_of[c]) for c in frontier2) > MAX_SLOTS:
            break
        top, frontier = top2, frontier2
    _, top, frontier, bins = best
    top_set = set(top)
    dead = set(c for c in of_clause if c >= 0) - live
    if dead:
        b = min(bins, key=lambda b: b[2])
        b[0] += sorted(dead)
        b[1] |= set().union(*(closure(c) for c in dead))
    bins = [(r, cls) for r, cls, _ in bins]
    # what the top reads of the parts: names owned by frontier clauses
    top_stmts = [s for c in top for s in of_clause[c]]
    wanted = list(dict.fromkeys(
        [a for s in top_stmts for a in operands(s)]
        + [o for o in outs if isinstance(o, str)]))
    slot_of, parts = {}, []
    for roots, cl in bins:
        roots = set(roots)
        pouts = []
        for n in wanted:
            if owner[n] in roots and owner[n] not in top_set \
                    and n not in slot_of:
                slot_of[n] = len(slot_of)
                pouts.append((n, slot_of[n]))
        body = [s for s in stmts if s.clause in cl]
        ins = {a for s in body for a in operands(s) if owner[a] == -1}
        body = [s for s in stmts if s.clause == -1 and s.name in ins] + body
        order = schedule(body, [n for n, _ in pouts]) if body else []
        parts.append(Part(sorted(roots), order, pouts))
    loads = [Stmt(n, by[n].ty, "part", (slot_of[n],), owner[n])
             for n in wanted if n in slot_of]
    ins = {a for s in top_stmts for a in operands(s) if owner[a] == -1}
    ins |= {o for o in outs if isinstance(o, str) and owner[o] == -1}
    # an input no statement reads: the top's (never stored)
    ins |= {s.name for s in stmts if s.clause == -1} - {
        a for s in stmts for a in operands(s)}
    tbody = ([s for s in stmts if s.clause == -1 and s.name in ins] + loads
             + [s for s in stmts if s.clause in top_set])
    return Split(parts, schedule(tbody, outs), tuple(outs), top, len(slot_of))


# ---------------------------------------------------------------------------
# The plain replay
# ---------------------------------------------------------------------------

_BIN = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b, "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b, "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b, "and": lambda a, b: a & b,
        "or": lambda a, b: a | b}
_CALL = {"fabsf": tc.abs, "sqrtf": tc.sqrt, "sinf": torch.sin,
         "cosf": torch.cos, "expf": torch.exp, "logf": torch.log,
         "floorf": torch.floor, "ceilf": torch.ceil,
         "isfinite": torch.isfinite, "asinf": torch.asin,
         "acosf": torch.acos, "atanf": torch.atan, "c_asin": tc.asin,
         "c_acos": tc.acos, "c_atan": tc.atan}


def _full(v, like):
    return torch.full_like(like, v) if isinstance(v, float) else v


def _eval(s: Stmt, env, ins, imms, shared, dev):
    if s.op == "in":
        return ins[s.args[0]]
    if s.op == "imm":
        return imms[s.args[0]]
    if s.op == "part":
        return shared[s.args[0]]
    a = [env[v] if isinstance(v, str) else v for v in s.args]
    if all(isinstance(v, float) for v in a):
        a = [torch.tensor(v, dtype=torch.float32, device=dev) for v in a]
    if s.op in _BIN:
        return _BIN[s.op](*a)
    if s.op == "neg":
        return -a[0]
    if s.op == "div":
        x, y = a
        like = y if isinstance(x, float) else x
        return torch.div(_full(x, like), _full(y, like))
    if s.op in ("nmin", "nmax"):
        like = a[1] if isinstance(a[0], float) else a[0]
        fn = tc.minimum if s.op == "nmin" else tc.maximum
        return fn(_full(a[0], like), _full(a[1], like))
    if s.op == "sel":
        c, x, y = a
        return torch.where(c, *(torch.tensor(v, dtype=torch.float32,
                                             device=dev)
                                if isinstance(v, float) else v
                                for v in (x, y)))
    return _CALL[s.op](a[0])


def replay(order, ins, imms=None, shared=None, env=None):
    """Run ``order`` in plain PyTorch on the lanes ``ins`` (tensors of one
    shape; ``imms`` indexable by clause under ``take_imms``; ``shared``
    the parts' slots for a top).  A statement reading a name not made
    before it in ``order`` raises ``KeyError``.  Returns the names'
    values."""
    env = {} if env is None else env
    dev = ins[0].device
    for s in order:
        env[s.name] = _eval(s, env, ins, imms, shared, dev)
    return env


def outputs(env, outs, like):
    """The program's outputs as tensors of ``like``'s shape."""
    return tuple(torch.full_like(like, o) if isinstance(o, float)
                 else env[o].expand_as(like).clone() for o in outs)


def replay_split(sp: Split, ins, imms=None):
    """The split form in plain PyTorch: each part alone, its results into
    the shared slots, then the top from them."""
    shared = {}
    for p in sp.parts:
        env = replay(p.order, ins, imms)
        for n, k in p.outs:
            shared[k] = env[n]
    env = replay(sp.top, ins, imms, shared)
    return outputs(env, sp.outs, ins[0])
