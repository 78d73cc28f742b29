"""libfive ``.frep`` Archive reader/writer (packed-opcode build).

The reference loads benchmark models through ``libfive::Archive``
(``reference/benchmark/render_2d_table.cpp:31-39``); the build forces
``LIBFIVE_PACKED_OPCODES`` (``reference/CMakeLists.txt:5-8``), which is
the numbering this module implements.  The wire format (reverse-engineered
from the six bundled ``benchmark/files/*.frep`` archives and validated by
rendering them):

    archive   := shape* 0xFF
    shape     := 'T' string string clause* 0xFF var*
    var       := 'V' u32-id string
    string    := '"' (escaped chars) '"'
    clause    := opcode-byte payload
    payload   := f32-LE                 (CONSTANT)
               | u32 lhs-id            (unary ops; also CONST_VAR, whose
                                        child is the CONSTANT holding the
                                        variable's value -- named by a
                                        trailing 'V' record)
               | u32 rhs-id u32 lhs-id (binary ops; rhs serialized FIRST --
                                        a fallthrough-switch idiom in
                                        libfive's serializer)
               | (nothing)             (VAR_X/Y/Z, VAR_FREE)

Ids are dense 0-based indices into the stream of clauses serialized so far
(shared across shapes in one archive).  The shape's root is its last clause.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .tree import Tree, CONSTANT, PARAM, VAR_X, VAR_Y, VAR_Z

# Packed libfive opcode numbering (declaration order of libfive's
# Opcode enum; empirically verified against the bundled archives).
PACKED_OPCODES: Tuple[str, ...] = (
    "invalid", "const", "var-x", "var-y", "var-z", "var-free", "const-var",
    "square", "sqrt", "neg", "sin", "cos", "tan", "asin", "acos", "atan",
    "exp", "abs", "log", "recip",
    "add", "mul", "min", "max", "sub", "div",
    "atan2", "pow", "nth-root", "mod", "nanfill", "compare",
    "oracle", "last-op",
)
_PACKED_INDEX: Dict[str, int] = {n: i for i, n in enumerate(PACKED_OPCODES)}

_UNARY = set(PACKED_OPCODES[7:20])
_BINARY = set(PACKED_OPCODES[20:32])


@dataclass
class ArchiveShape:
    tree: Tree
    name: str = ""
    doc: str = ""
    # serialized-id -> var name, as read from / written to 'V' records.
    # After loads() post-processing the same names appear as PARAM nodes
    # in ``tree`` (frontend var()), which is the API the rest of the
    # framework uses; this dict is kept as wire-level provenance.
    vars: Dict[int, str] = field(default_factory=dict)


def _rename_params(tree: Tree, mapping: Dict[str, str]) -> Tree:
    """Rebuild ``tree`` with PARAM nodes renamed per ``mapping`` (keys are
    provisional names).  Used by loads(): 'V' name records trail the
    shape's clauses, so params are first built with placeholder names."""
    memo: Dict[int, Tree] = {}
    for n in tree.ordered_dfs():
        if n.op == PARAM and n.name in mapping:
            memo[n._id] = Tree(PARAM, value=n.value,
                               name=mapping[n.name])
        elif n.children():
            kids = [memo.get(c._id, c) for c in n.children()]
            if any(k is not c for k, c in zip(kids, n.children())):
                memo[n._id] = (Tree(n.op, kids[0]) if len(kids) == 1
                               else Tree(n.op, kids[0], kids[1]))
    return memo.get(tree._id, tree)


def _read_string(data: bytes, pos: int) -> Tuple[str, int]:
    if data[pos] != ord('"'):
        raise ValueError(f"expected quoted string at byte {pos}")
    pos += 1
    out = bytearray()
    while True:
        c = data[pos]
        pos += 1
        if c == ord('"'):
            break
        if c == ord('\\'):
            c = data[pos]
            pos += 1
        out.append(c)
    return out.decode("utf-8", errors="replace"), pos


def loads(data: bytes) -> List[ArchiveShape]:
    """Deserialize a ``.frep`` archive into a list of shapes."""
    pos = 0
    shapes: List[ArchiveShape] = []
    nodes: List[Tree] = []       # global id space across the archive
    cv_alias: Dict[int, int] = {}  # const serial -> wrapping const-var serial
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0xFF:          # end-of-archive
            break
        if tag == ord('V'):
            (idx,) = struct.unpack_from("<I", data, pos)
            pos += 4
            vname, pos = _read_string(data, pos)
            if shapes:
                shapes[-1].vars[idx] = vname
            continue
        if tag != ord('T'):
            raise ValueError(f"unknown archive tag {tag:#x} at byte {pos - 1}")
        name, pos = _read_string(data, pos)
        doc, pos = _read_string(data, pos)
        root: Optional[Tree] = None
        while data[pos] != 0xFF:
            op = data[pos]
            pos += 1
            if op >= len(PACKED_OPCODES):
                raise ValueError(f"bad opcode {op} at byte {pos - 1}")
            nm = PACKED_OPCODES[op]
            if nm == "const":
                (v,) = struct.unpack_from("<f", data, pos)
                pos += 4
                node = Tree(CONSTANT, value=v)
            elif nm == "const-var":
                # libfive CONST_VAR: a constant marked as a free variable
                # (Studio's draggable vars).  Built as a PARAM with a
                # placeholder name; the trailing 'V' record renames it
                # (post-pass below).
                (l,) = struct.unpack_from("<I", data, pos)
                pos += 4
                child = nodes[l]
                if child.op != CONSTANT:
                    raise ValueError("const-var over a non-constant")
                cv_alias[l] = len(nodes)
                node = Tree(PARAM, value=child.value,
                            name=f"__frep_v{len(nodes)}")
            elif nm in _UNARY:
                (l,) = struct.unpack_from("<I", data, pos)
                pos += 4
                node = Tree(nm, nodes[l])
            elif nm in _BINARY:
                # rhs id is serialized first (fallthrough switch in libfive)
                r, l = struct.unpack_from("<II", data, pos)
                pos += 8
                node = Tree(nm, nodes[l], nodes[r])
            elif nm == "var-x":
                node = Tree(VAR_X)
            elif nm == "var-y":
                node = Tree(VAR_Y)
            elif nm == "var-z":
                node = Tree(VAR_Z)
            elif nm == "var-free":
                # valueless free variable (libfive binds it externally at
                # eval time); becomes a PARAM defaulting to 0.0 so such
                # archives still compile and render — the reference's
                # tape compiler rejects VAR_FREE outright
                # (reference/src/tape.cpp:182-196)
                node = Tree(PARAM, value=0.0,
                            name=f"__frep_v{len(nodes)}")
            else:
                raise ValueError(f"unsupported clause {nm!r} in archive")
            nodes.append(node)
            root = node
        pos += 1  # consume the shape's 0xFF terminator
        if root is None:
            raise ValueError("empty shape in archive")
        shapes.append(ArchiveShape(tree=root, name=name, doc=doc))
    # post-pass: 'V' records trail each shape, so params were built with
    # placeholder names — rebuild trees with the real names (a 'V' id may
    # reference either the const-var clause or its const child)
    for s in shapes:
        if not s.vars:
            continue
        mapping = {}
        for idx, vname in s.vars.items():
            sid = cv_alias.get(idx, idx)
            mapping[f"__frep_v{sid}"] = vname
        s.tree = _rename_params(s.tree, mapping)
    return shapes


def load(path: str) -> List[ArchiveShape]:
    with open(path, "rb") as f:
        return loads(f.read())


def _write_string(out: bytearray, s: str) -> None:
    out.append(ord('"'))
    for ch in s.encode("utf-8"):
        if ch in (ord('"'), ord('\\')):
            out.append(ord('\\'))
        out.append(ch)
    out.append(ord('"'))


def dumps(shapes: List[ArchiveShape]) -> bytes:
    """Serialize shapes to a byte-compatible ``.frep`` archive."""
    out = bytearray()
    ids: Dict[int, int] = {}
    next_id = [0]

    def emit_tree(t: Tree) -> list:
        """Emit clauses; returns [(serialized-id, var-name)] for params
        (written as const + const-var, the libfive Studio idiom)."""
        vars_out = []
        for n in t.ordered_dfs():
            if n.id in ids:
                if n.op == PARAM:
                    vars_out.append((ids[n.id], n.name))
                continue
            if n.op == CONSTANT:
                ids[n.id] = next_id[0]
                next_id[0] += 1
                out.append(_PACKED_INDEX["const"])
                out.extend(struct.pack("<f", n.value))
            elif n.op == PARAM:
                # const holding the value, then const-var marking it
                cnode = Tree(CONSTANT, value=n.value)
                if cnode.id not in ids:
                    ids[cnode.id] = next_id[0]
                    next_id[0] += 1
                    out.append(_PACKED_INDEX["const"])
                    out.extend(struct.pack("<f", n.value))
                ids[n.id] = next_id[0]
                next_id[0] += 1
                out.append(_PACKED_INDEX["const-var"])
                out.extend(struct.pack("<I", ids[cnode.id]))
                vars_out.append((ids[n.id], n.name))
            elif n.op in _UNARY:
                ids[n.id] = next_id[0]
                next_id[0] += 1
                out.append(_PACKED_INDEX[n.op])
                out.extend(struct.pack("<I", ids[n.lhs.id]))
            elif n.op in _BINARY:
                ids[n.id] = next_id[0]
                next_id[0] += 1
                out.append(_PACKED_INDEX[n.op])
                out.extend(struct.pack("<II", ids[n.rhs.id], ids[n.lhs.id]))
            else:
                ids[n.id] = next_id[0]
                next_id[0] += 1
                out.append(_PACKED_INDEX[n.op])
        return vars_out

    for s in shapes:
        out.append(ord('T'))
        _write_string(out, s.name)
        _write_string(out, s.doc)
        vars_out = emit_tree(s.tree)
        out.append(0xFF)
        for idx, vname in vars_out:
            out.append(ord('V'))
            out.extend(struct.pack("<I", idx))
            _write_string(out, vname)
    out.append(0xFF)
    return bytes(out)


def dump(shapes: List[ArchiveShape], path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(shapes))
