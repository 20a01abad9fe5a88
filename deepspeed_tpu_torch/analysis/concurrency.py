"""AST-based concurrency lint for the threaded serving/telemetry stack.

Counterpart of ``deepspeed_tpu/analysis/concurrency.py`` (pure stdlib, the
same checks). The package it reads is a parameter: ``deepspeed_tpu_torch``
by default, and ``deepspeed_tpu`` holds this copy to the JAX package's
analyzer on the JAX sources.

Three checks over declared lock discipline (docs/CONCURRENCY.md):

1. **Guarded fields** — a class declares its guarded state::

       _GUARDED_BY = {"_inflight": "_lock",          # reads AND writes
                      "replicas": "_membership_lock:writes"}  # writes only

   (or per-field ``# guarded-by: _lock`` trailing comments on the
   ``__init__`` assignment). Every method's reads/writes of a guarded
   field must happen inside ``with self.<lock>``; helper-method
   indirection is resolved ONE level deep — an access in a helper is
   fine when every same-class call site of that helper holds the lock
   (the ``_foo_locked`` caller-holds-the-lock convention, verified
   instead of trusted). ``__init__`` is exempt (the object is not yet
   shared). The ``:writes`` mode covers the rebind-under-lock /
   lock-free-snapshot-read publication pattern.

2. **Lock order** — the cross-module graph of nested acquisitions:
   lexically nested ``with`` blocks plus calls made while holding a
   lock, resolved one level into the callee (same-class calls exactly;
   cross-object calls via constructor/parameter-annotation attribute
   types, falling back to unique-method-name matching). Lock identity
   is the :data:`~deepspeed_tpu_torch.utils.locks.LOCK_RANKS` rank name when
   declared (``RankedLock("name")`` or a ``_LOCK_RANKS`` class hint for
   plain locks), else ``Class.attr``. Findings: any edge from a ranked
   lock to an equal-or-lower rank (the same inversion the runtime
   debug mode raises on), and any cycle in the whole graph.

3. **Blocking while locked** — ``join``/``Event.wait``/``time.sleep``/
   engine ``forward``/``block_until_ready``/file+disk I/O inside a
   ``with <lock>`` body (directly, or one call level deep) — the
   pattern behind past serving wedges.

Audited exceptions live in ``analysis/baseline.toml`` (see
:mod:`deepspeed_tpu_torch.analysis.baseline`): every entry needs a
justification, and an entry matching no current finding is itself an
error — the baseline can only shrink silently, never rot.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: the package analyzed by default: its ``utils/locks.py`` holds the rank
#: table, its ``serving/metrics.py`` and ``telemetry/journal.py`` the
#: declared names
DEFAULT_PACKAGE = "deepspeed_tpu_torch"

#: default analysis scope: the port's threaded modules (one entry per
#: layer; directories are walked recursively)
DEFAULT_PATHS = (
    "deepspeed_tpu_torch/serving",
    "deepspeed_tpu_torch/telemetry",
    "deepspeed_tpu_torch/utils/locks.py",
    "deepspeed_tpu_torch/utils/restart.py",
    "deepspeed_tpu_torch/runtime/resilience.py",
)

#: method names never resolved by the unique-name fallback: they collide
#: with builtin-container methods on untyped receivers (``d.pop(...)``
#: must not resolve to ``AdmissionQueue.pop``). Typed receivers
#: (constructor / annotation attribute types) still resolve exactly.
_FALLBACK_BLOCKLIST = frozenset({
    "pop", "get", "put", "add", "remove", "clear", "update", "append",
    "extend", "discard", "count", "index", "copy", "keys", "values",
    "items", "setdefault", "popleft", "appendleft", "sort", "close",
    "start", "set", "join", "wait",
})

#: receiver names that mark ``.write``/``.flush`` as file I/O
_FILEISH = frozenset({"fh", "f", "_fh", "file", "_file", "sink", "_sink"})

_GUARDED_COMMENT = re.compile(
    r"self\.(\w+)\s*(?::[^=]+)?=.*#\s*guarded-by:\s*(\w+)(:writes)?")


@dataclasses.dataclass
class Finding:
    check: str       # guarded-field | lock-order | lock-cycle |
    #                # blocking-while-locked | metric-name | journal-kind |
    #                # stale-baseline | baseline-unjustified
    path: str        # repo-relative
    line: int
    qualname: str    # "Class.method" (or "<module>")
    token: str       # the stable discriminator (field / edge / op / name)
    detail: str

    @property
    def baseline_id(self) -> str:
        """Stable id for baseline matching: no line numbers, so audited
        exceptions survive unrelated edits."""
        return f"{self.check}:{self.path}:{self.qualname}:{self.token}"

    def render(self) -> str:
        return (f"LINT {self.check} {self.path}:{self.line} "
                f"[{self.qualname}] {self.token} — {self.detail}")


@dataclasses.dataclass
class LockDecl:
    attr: str
    rank_name: Optional[str]      # LOCK_RANKS key, or None (unranked)
    kind: str = "lock"            # "lock" | "condition"
    reentrant: bool = False       # RLock / RankedLock(reentrant=True)


class ClassModel:
    def __init__(self, name: str, path: str, node: ast.ClassDef):
        self.name = name
        self.path = path
        self.node = node
        self.guarded: Dict[str, Tuple[str, str]] = {}   # field -> (lock, mode)
        self.locks: Dict[str, LockDecl] = {}
        self.rank_hints: Dict[str, str] = {}            # _LOCK_RANKS
        self.attr_types: Dict[str, str] = {}            # self.x -> type name
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.scans: Dict[str, "_FnScan"] = {}

    def lock_id(self, attr: str) -> str:
        decl = self.locks.get(attr)
        if decl is not None and decl.rank_name:
            return decl.rank_name
        hint = self.rank_hints.get(attr)
        if hint:
            return hint
        return f"{self.name}.{attr}"


# --------------------------------------------------------------- extraction

def _const_str(node) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def _dict_str_pairs(node) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            ks, vs = _const_str(k), _const_str(v)
            if ks is not None and vs is not None:
                out[ks] = vs
    return out


def _lock_ctor(value: ast.AST) -> Optional[LockDecl]:
    """LockDecl for ``threading.Lock()``/``RLock()``/``Condition()`` and
    ``RankedLock("name")``/``RankedCondition("name")`` constructor
    expressions; None for anything else."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name in ("Lock", "RLock"):
        return LockDecl("", None, "lock", reentrant=name == "RLock")
    if name == "Condition":
        return LockDecl("", None, "condition")
    if name in ("RankedLock", "RankedCondition"):
        rank = _const_str(value.args[0]) if value.args else None
        reentrant = any(
            kw.arg == "reentrant" and isinstance(kw.value, ast.Constant)
            and bool(kw.value.value) for kw in value.keywords)
        return LockDecl("", rank,
                        "condition" if name == "RankedCondition" else "lock",
                        reentrant=reentrant)
    return None


def _type_of_ctor(value: ast.AST) -> Optional[str]:
    """Best-effort static type of an assigned expression: constructor
    calls yield the class name, literals yield builtin names."""
    if isinstance(value, ast.Call):
        fn = value.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    return None


def _build_class_model(path: str, node: ast.ClassDef,
                       source_lines: Sequence[str]) -> ClassModel:
    cm = ClassModel(node.name, path, node)
    for stmt in node.body:
        # class-level declarations
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            tname = stmt.targets[0].id
            if tname == "_GUARDED_BY":
                for field, spec in _dict_str_pairs(stmt.value).items():
                    lock, _, mode = spec.partition(":")
                    cm.guarded[field] = (lock, mode or "all")
            elif tname == "_LOCK_RANKS":
                cm.rank_hints.update(_dict_str_pairs(stmt.value))
            else:
                decl = _lock_ctor(stmt.value)
                if decl is not None:
                    decl.attr = tname
                    cm.locks[tname] = decl
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cm.methods[stmt.name] = stmt
    init = cm.methods.get("__init__")
    if init is not None:
        # parameter annotations type the attrs they are stored into
        ann: Dict[str, str] = {}
        for a in init.args.args + init.args.kwonlyargs:
            if a.annotation is not None:
                t = a.annotation
                if isinstance(t, ast.Name):
                    ann[a.arg] = t.id
                elif isinstance(t, ast.Constant) and isinstance(t.value, str):
                    ann[a.arg] = t.value.split("[")[0].strip("\"'")
        for stmt in ast.walk(init):
            target = None
            value = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            attr = target.attr
            decl = _lock_ctor(value)
            if decl is not None:
                decl.attr = attr
                cm.locks[attr] = decl
                continue
            if isinstance(value, ast.Name) and value.id in ann:
                cm.attr_types[attr] = ann[value.id]
            else:
                t = _type_of_ctor(value)
                if t is not None:
                    cm.attr_types[attr] = t
    # trailing-comment guards: ``self._x = ...  # guarded-by: _lock``
    lo = node.lineno - 1
    hi = max(getattr(node, "end_lineno", lo) or lo, lo)
    for raw in source_lines[lo:hi]:
        m = _GUARDED_COMMENT.search(raw)
        if m and m.group(1) not in cm.guarded:
            cm.guarded[m.group(1)] = (m.group(2),
                                      "writes" if m.group(3) else "all")
    return cm


# ------------------------------------------------------------- method scan

class _FnScan(ast.NodeVisitor):
    """One pass over a method body tracking the held self-lock stack."""

    def __init__(self, cm: ClassModel, fn: ast.FunctionDef):
        self.cm = cm
        self.fn = fn
        # held entries: a local lock attr name (str), or a foreign
        # descriptor ("typed", TypeName, attr) for another object's lock
        self.held: List[object] = []
        self.accesses: List[tuple] = []   # (field, is_write, held, line)
        self.calls: List[tuple] = []      # (recv_desc, meth, held, line)
        self.nested: List[tuple] = []     # (outer_desc, inner_desc, line)
        self.blocking: List[tuple] = []   # (op_token, held, line)
        self.acquired: List[str] = []     # every LOCAL lock attr taken
        self.method_refs: set = set()     # self.<m> taken as a VALUE
        self._callfuncs: set = set()      # id() of Call.func nodes
        # parameter annotations type foreign lock receivers
        self._param_types: Dict[str, str] = {}
        for a in fn.args.args + fn.args.kwonlyargs:
            t = a.annotation
            if isinstance(t, ast.Name):
                self._param_types[a.arg] = t.id
            elif isinstance(t, ast.Constant) and isinstance(t.value, str):
                self._param_types[a.arg] = \
                    t.value.split("[")[0].strip("\"'")
        self.visit(fn)

    # -------------------------------------------------------------- helpers
    def _lock_attr(self, expr) -> Optional[str]:
        """Lock attribute name when ``expr`` denotes one of this class's
        locks (``self._x`` or ``ClassName._x``)."""
        if isinstance(expr, ast.Attribute):
            v = expr.value
            if isinstance(v, ast.Name) and v.id in ("self", self.cm.name) \
                    and expr.attr in self.cm.locks:
                return expr.attr
        return None

    def _foreign_lock(self, expr) -> Optional[tuple]:
        """("typed", TypeName, attr) when ``expr`` denotes ANOTHER
        object's lock attribute and the receiver's type is statically
        known — ``replica._lock`` via a parameter annotation, or
        ``self.router._membership_lock`` via a constructor-typed attr.
        The edge resolves against that class's lock table at graph
        time, so cross-object lexical nesting joins the order checks."""
        if not isinstance(expr, ast.Attribute):
            return None
        recv = expr.value
        if isinstance(recv, ast.Name) and recv.id in self._param_types:
            return ("typed", self._param_types[recv.id], expr.attr)
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self" \
                and recv.attr in self.cm.attr_types:
            return ("typed", self.cm.attr_types[recv.attr], expr.attr)
        return None

    @staticmethod
    def _src(expr) -> str:
        try:
            return ast.unparse(expr)
        except Exception:   # pragma: no cover - py fallback
            return ""

    # ---------------------------------------------------------------- walk
    def visit_FunctionDef(self, node) -> None:
        if node is self.fn:
            for stmt in node.body:
                self.visit(stmt)
        # nested defs/lambdas run later, on an unknown lock context:
        # scan them with an EMPTY held stack (their guarded accesses
        # still register, attributed to this method)
        else:
            saved, self.held = self.held, []
            for stmt in node.body:
                self.visit(stmt)
            self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        saved, self.held = self.held, []
        self.visit(node.body)
        self.held = saved

    def visit_With(self, node) -> None:
        taken: List[object] = []
        for item in node.items:
            self.visit(item.context_expr)
            attr = self._lock_attr(item.context_expr)
            desc: Optional[object] = attr
            if attr is not None:
                self.acquired.append(attr)
            else:
                desc = self._foreign_lock(item.context_expr)
            if desc is not None:
                decl = self.cm.locks.get(attr) if attr is not None \
                    else None
                if self.held and not (desc in self.held and decl
                                      and decl.reentrant):
                    # same-attribute re-entry of a reentrant lock is the
                    # one legal same-lock nesting; everything else —
                    # including a PEER instance's equally-named lock and
                    # a typed foreign lock — becomes an edge the order
                    # checks see
                    self.nested.append((self.held[-1], desc,
                                        item.context_expr.lineno))
                taken.append(desc)
        self.held.extend(taken)
        for stmt in node.body:
            self.visit(stmt)
        if taken:
            del self.held[-len(taken):]

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            if node.attr in self.cm.guarded:
                self.accesses.append(
                    (node.attr,
                     isinstance(node.ctx, (ast.Store, ast.Del)),
                     tuple(self.held), node.lineno))
            # a method taken as a VALUE (callback wiring, not a call)
            # escapes the intra-class call graph — the guarded-field
            # fixpoint must treat it as an entry point
            if node.attr in self.cm.methods \
                    and isinstance(node.ctx, ast.Load) \
                    and id(node) not in self._callfuncs:
                self.method_refs.add(node.attr)
        self.generic_visit(node)

    # ------------------------------------------------------------ blocking
    def _blocking_token(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Name):
            return "open" if fn.id == "open" else None
        if not isinstance(fn, ast.Attribute):
            return None
        meth = fn.attr
        recv = fn.value
        recv_name = recv.id if isinstance(recv, ast.Name) else (
            recv.attr if isinstance(recv, ast.Attribute) else "")
        if self._lock_attr(recv) is not None:
            return None            # ops on our own locks (condition wait)
        if meth == "sleep" and recv_name == "time":
            return "time.sleep"
        if meth in ("fsync", "replace", "makedirs") and recv_name == "os":
            return f"os.{meth}"
        if meth == "dump" and recv_name == "json":
            return "json.dump"
        if meth in ("block_until_ready", "forward", "forward_verify"):
            return meth
        if meth == "join" and "thread" in self._src(recv).lower():
            return "join"
        if meth == "wait":
            return "wait"
        if meth in ("write", "flush") and recv_name in _FILEISH:
            return f"file.{meth}"
        return None

    def visit_Call(self, node) -> None:
        self._callfuncs.add(id(node.func))
        tok = self._blocking_token(node)
        if tok is not None:
            self.blocking.append((tok, tuple(self.held), node.lineno))
        fn = node.func
        if isinstance(fn, ast.Attribute) and self._lock_attr(fn) is None \
                and self._lock_attr(fn.value) is None:
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                desc = ("self",)
            elif isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                desc = ("self_attr", recv.attr)
            elif isinstance(recv, ast.Name):
                desc = ("name", recv.id)
            else:
                desc = ("other",)
            self.calls.append((desc, fn.attr, tuple(self.held), node.lineno))
        self.generic_visit(node)


# --------------------------------------------------------------- the model

class RepoModel:
    def __init__(self, root: str, lock_ranks: Dict[str, int]):
        self.root = root
        self.lock_ranks = dict(lock_ranks)
        self.classes: List[ClassModel] = []
        self.by_name: Dict[str, ClassModel] = {}
        self.method_index: Dict[str, List[ClassModel]] = {}

    def add_source(self, path: str, source: str) -> None:
        tree = ast.parse(source)
        lines = source.splitlines()
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                cm = _build_class_model(path, node, lines)
                for mname, fn in cm.methods.items():
                    cm.scans[mname] = _FnScan(cm, fn)
                self.classes.append(cm)
                self.by_name[cm.name] = cm
                for mname in cm.methods:
                    self.method_index.setdefault(mname, []).append(cm)

    # ------------------------------------------------------------ resolution
    def _resolve_call(self, cm: ClassModel, desc, meth: str
                      ) -> List[ClassModel]:
        if desc[0] == "self":
            return [cm] if meth in cm.methods else []
        if desc[0] == "self_attr":
            t = cm.attr_types.get(desc[1])
            if t is not None:
                target = self.by_name.get(t)
                if target is not None:
                    return [target] if meth in target.methods else []
                return []          # typed to something un-analyzed: stop
        if meth in _FALLBACK_BLOCKLIST:
            return []
        # unique-name fallback over classes whose method takes locks or
        # blocks — the cross-object edges (router -> replica) the graph
        # needs; conservative (every candidate contributes edges)
        out = []
        for cand in self.method_index.get(meth, []):
            scan = cand.scans.get(meth)
            if scan is not None and (scan.acquired or any(
                    not h for _, h, _ in scan.blocking)):
                out.append(cand)
        return out

    # ------------------------------------------------------------ findings
    @staticmethod
    def _is_private(mname: str) -> bool:
        return mname.startswith("_") and not (
            mname.startswith("__") and mname.endswith("__"))

    def _entry_held(self, cm: ClassModel) -> Dict[str, frozenset]:
        """Locks provably held at EVERY same-class entry of each private
        helper (the caller-holds-the-lock convention, verified): a
        fixpoint over the intra-class call graph, so ``offer ->
        _push_locked -> _note_depth`` chains resolve. Public methods and
        dunders are entry points (anything may call them lock-free);
        ``__init__`` call sites are excluded (the object is not yet
        shared there, matching the access exemption)."""
        sites: Dict[str, List[tuple]] = {}
        refs: set = set()
        for mname, scan in cm.scans.items():
            refs |= scan.method_refs
            if mname == "__init__":
                continue
            for desc, meth, held, _ in scan.calls:
                if desc == ("self",) and meth in cm.methods:
                    sites.setdefault(meth, []).append(
                        (mname, frozenset(held)))
        all_locks = frozenset(cm.locks) | frozenset(cm.rank_hints)
        held_on_entry: Dict[str, frozenset] = {}
        for mname in cm.methods:
            # a method whose reference escapes (callback wiring like
            # ``self.cb = self._helper``) can run on any thread with
            # nothing held — it is an entry point no matter what its
            # same-class call sites hold, which also grounds otherwise
            # closed helper-call cycles that would keep the optimistic
            # seed forever
            held_on_entry[mname] = (
                all_locks if self._is_private(mname) and sites.get(mname)
                and mname not in refs
                else frozenset())
        changed = True
        while changed:
            changed = False
            for mname in cm.methods:
                slist = sites.get(mname)
                if not slist or not self._is_private(mname) \
                        or mname in refs:
                    continue
                new: Optional[frozenset] = None
                for caller, held in slist:
                    eff = held | held_on_entry.get(caller, frozenset())
                    new = eff if new is None else (new & eff)
                if new != held_on_entry[mname]:
                    held_on_entry[mname] = new
                    changed = True
        return held_on_entry

    def check_guarded(self) -> List[Finding]:
        findings: List[Finding] = []
        for cm in self.classes:
            if not cm.guarded:
                continue
            entry = self._entry_held(cm)
            for mname, scan in cm.scans.items():
                if mname == "__init__":
                    continue
                for field, is_write, held, line in scan.accesses:
                    spec = cm.guarded.get(field)
                    if spec is None:
                        continue
                    lock, mode = spec
                    if mode == "writes" and not is_write:
                        continue
                    if lock in held or lock in entry.get(mname, ()):
                        continue
                    findings.append(Finding(
                        "guarded-field", cm.path, line,
                        f"{cm.name}.{mname}", field,
                        f"{'write to' if is_write else 'read of'} "
                        f"{field!r} outside `with self.{lock}` "
                        f"(held: {list(held) or 'none'})"))
        return findings

    def _desc_lock_id(self, cm: ClassModel, desc) -> Optional[str]:
        """Lock id for a held-stack descriptor: a local attr name, or a
        typed foreign ("typed", TypeName, attr) entry — None when the
        foreign type is not an analyzed lock-owning class."""
        if isinstance(desc, str):
            return cm.lock_id(desc)
        if isinstance(desc, tuple) and desc[0] == "typed":
            target = self.by_name.get(desc[1])
            if target is not None and desc[2] in target.locks:
                return target.lock_id(desc[2])
        return None

    def _edges(self) -> List[tuple]:
        """(outer_id, inner_id, path, qualname, line) acquisition edges."""
        edges: List[tuple] = []
        for cm in self.classes:
            for mname, scan in cm.scans.items():
                qual = f"{cm.name}.{mname}"
                for outer, inner, line in scan.nested:
                    oid = self._desc_lock_id(cm, outer)
                    iid = self._desc_lock_id(cm, inner)
                    if oid is not None and iid is not None:
                        edges.append((oid, iid, cm.path, qual, line))
                for desc, meth, held, line in scan.calls:
                    if not held:
                        continue
                    oid = self._desc_lock_id(cm, held[-1])
                    if oid is None:
                        continue
                    for target in self._resolve_call(cm, desc, meth):
                        tscan = target.scans.get(meth)
                        if tscan is None:
                            continue
                        for attr in dict.fromkeys(tscan.acquired):
                            decl = target.locks.get(attr)
                            if (target is cm and attr == held[-1]
                                    and decl and decl.reentrant
                                    and desc == ("self",)):
                                continue    # legal reentrant re-entry
                            edges.append((oid, target.lock_id(attr),
                                          cm.path, qual, line))
        return edges

    def check_lock_order(self) -> List[Finding]:
        findings: List[Finding] = []
        edges = self._edges()
        seen = set()
        graph: Dict[str, set] = {}
        for outer, inner, path, qual, line in edges:
            # same-id edges stay: a PEER instance's equally-ranked lock
            # (two replicas merging into each other) is the classic
            # unordered AB-BA deadlock — ranked ids fail the rank check
            # below, unranked ids surface as a self-loop cycle
            graph.setdefault(outer, set()).add(inner)
            ro, ri = self.lock_ranks.get(outer), self.lock_ranks.get(inner)
            if ro is not None and ri is not None and ro >= ri:
                key = (outer, inner, qual)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    "lock-order", path, line, qual, f"{outer}->{inner}",
                    f"acquires {inner!r} (rank {ri}) while holding "
                    f"{outer!r} (rank {ro}) — rank order says "
                    f"{outer!r} must be inner"))
        findings.extend(self._cycles(graph))
        return findings

    def _cycles(self, graph: Dict[str, set]) -> List[Finding]:
        findings: List[Finding] = []
        seen_cycles = set()
        path: List[str] = []
        on_path: set = set()
        done: set = set()

        def dfs(node: str) -> None:
            path.append(node)
            on_path.add(node)
            for nxt in sorted(graph.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # normalize rotation for a stable token
                    body = cyc[:-1]
                    k = body.index(min(body))
                    norm = tuple(body[k:] + body[:k])
                    if norm not in seen_cycles:
                        seen_cycles.add(norm)
                        findings.append(Finding(
                            "lock-cycle", "<graph>", 0, "<lock-graph>",
                            "->".join(norm),
                            "cyclic lock acquisition (potential "
                            "deadlock): " + " -> ".join(norm + (norm[0],))))
                elif nxt not in done:
                    dfs(nxt)
            on_path.discard(node)
            path.pop()
            done.add(node)

        for n in sorted(graph):
            if n not in done:
                dfs(n)
        return findings

    @staticmethod
    def _held_repr(desc) -> str:
        if isinstance(desc, str):
            return f"self.{desc}"
        return f"{desc[1]}.{desc[2]}"

    def check_blocking(self) -> List[Finding]:
        findings: List[Finding] = []
        seen = set()
        # methods that block directly with no lock held (candidates for
        # the one-level call resolution)
        blocks_directly: Dict[Tuple[str, str], List[str]] = {}
        for cm in self.classes:
            for mname, scan in cm.scans.items():
                for tok, held, line in scan.blocking:
                    if held:
                        key = (cm.path, f"{cm.name}.{mname}", tok)
                        if key in seen:
                            continue
                        seen.add(key)
                        findings.append(Finding(
                            "blocking-while-locked", cm.path, line,
                            f"{cm.name}.{mname}", tok,
                            f"{tok} inside `with "
                            f"{self._held_repr(held[-1])}` — a blocked "
                            "holder wedges every waiter"))
                    else:
                        blocks_directly.setdefault(
                            (cm.name, mname), []).append(tok)
        for cm in self.classes:
            for mname, scan in cm.scans.items():
                for desc, meth, held, line in scan.calls:
                    if not held:
                        continue
                    all_toks: List[str] = []
                    for target in self._resolve_call(cm, desc, meth):
                        all_toks.extend(
                            blocks_directly.get((target.name, meth), ()))
                    if not all_toks:
                        continue
                    # one finding per (call site method, callee) with the
                    # CALLEE name alone as the stable token: the op list
                    # depends on which unique-name candidates exist
                    # elsewhere in the tree, and a baseline id must
                    # survive unrelated file additions (the ops stay in
                    # the detail text)
                    token = meth
                    key = (cm.path, f"{cm.name}.{mname}", token)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        "blocking-while-locked", cm.path, line,
                        f"{cm.name}.{mname}", token,
                        f"calls {meth}() (which does "
                        f"{', '.join(sorted(set(all_toks)))}) while "
                        f"holding {self._held_repr(held[-1])}"))
        return findings


# ------------------------------------------------------------- entry points

def parse_lock_ranks(root: str,
                     package: str = DEFAULT_PACKAGE) -> Dict[str, int]:
    """The rank table, read from ``<package>/utils/locks.py`` BY AST — the
    same declaration the runtime enforces, without importing the
    package."""
    path = os.path.join(root, package, "utils", "locks.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "LOCK_RANKS" \
                and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                ks = _const_str(k)
                if ks is not None and isinstance(v, ast.Constant):
                    out[ks] = int(v.value)
            return out
    raise ValueError(f"no LOCK_RANKS dict literal in {path}")


def iter_py_files(root: str, paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            out.append(p)
        elif os.path.isdir(full):
            for dirpath, _, names in os.walk(full):
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.append(os.path.relpath(
                            os.path.join(dirpath, n), root))
    return sorted(dict.fromkeys(out))


def build_model(root: str, paths: Sequence[str] = DEFAULT_PATHS,
                package: str = DEFAULT_PACKAGE) -> RepoModel:
    model = RepoModel(root, parse_lock_ranks(root, package))
    for rel in iter_py_files(root, paths):
        with open(os.path.join(root, rel)) as fh:
            model.add_source(rel, fh.read())
    return model


def analyze(root: str, paths: Sequence[str] = DEFAULT_PATHS,
            package: str = DEFAULT_PACKAGE) -> List[Finding]:
    """Run the three concurrency checks over ``paths`` with
    ``package``'s rank table; returns raw (un-baselined) findings."""
    model = build_model(root, paths, package)
    return (model.check_guarded() + model.check_lock_order()
            + model.check_blocking())


def analyze_source(source: str, path: str = "<fixture>.py",
                   lock_ranks: Optional[Dict[str, int]] = None
                   ) -> List[Finding]:
    """Analyze one source string (the test-fixture entry point)."""
    if lock_ranks is None:
        from ..utils.locks import LOCK_RANKS
        lock_ranks = dict(LOCK_RANKS)
    model = RepoModel("<memory>", lock_ranks)
    model.add_source(path, source)
    return (model.check_guarded() + model.check_lock_order()
            + model.check_blocking())
