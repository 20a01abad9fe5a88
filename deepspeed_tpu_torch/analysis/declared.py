"""Static declared-name audits: metric names and ops-journal kinds.

Counterpart of ``deepspeed_tpu/analysis/declared.py``; the audited package
is a parameter (``deepspeed_tpu_torch`` by default).

The runtime invariant (tested dynamically by the TestMetricNameAudit
idiom) is promoted to an AST pass over the whole
package, so it holds for code paths no test exercises:

- every ``counter(...)``/``gauge(...)``/``histogram(...)`` name used
  anywhere in the package must be pre-declared by
  ``serving_metrics()`` (serving/metrics.py) or the
  :class:`AlertEngine` pre-declaration block (telemetry/slo.py) —
  including f-string names, matched against the declared templates
  (``ttft_s_class_{cls}`` etc.);
- every ``journal.emit(kind, ...)`` kind must exist in
  ``EVENT_SCHEMAS`` (telemetry/journal.py).

Name arguments that are variables are resolved one level: enclosing
``for``-loop bindings over literal iterables (including class-attribute
tables like ``_PREFIX_COUNTERS``, position-aware for tuple targets),
local assignments (all string constants in the bound expression), and —
for journal kinds — literal arguments at same-class call sites when the
kind is a function parameter. A name the resolver cannot pin down is
itself a finding (baseline it with a justification, or make it
resolvable)."""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .concurrency import DEFAULT_PACKAGE, Finding, _const_str

_METRIC_METHODS = ("counter", "gauge", "histogram")

#: (package-relative module, function-qualname) scopes whose metric calls
#: DECLARE names
_DECLARING = (
    ("serving/metrics.py", None),        # whole module
    ("telemetry/slo.py", "AlertEngine.__init__"),
)


def _declaring(package: str):
    return tuple((f"{package}/{rel}", qual) for rel, qual in _DECLARING)

Template = Tuple[str, ...]     # static segments; gaps are placeholders


def _template_of(node: ast.JoinedStr) -> Template:
    segs: List[str] = [""]
    for part in node.values:
        if isinstance(part, ast.Constant):
            segs[-1] += str(part.value)
        else:
            segs.append("")
    return tuple(segs)


def _template_matches_const(tpl: Template, name: str) -> bool:
    if len(tpl) == 1:
        return tpl[0] == name
    if not name.startswith(tpl[0]) or not name.endswith(tpl[-1]):
        return False
    pos = len(tpl[0])
    for seg in tpl[1:-1]:
        i = name.find(seg, pos + 1)     # +1: placeholders are non-empty
        if i < 0:
            return False
        pos = i + len(seg)
    return len(name) - len(tpl[-1]) >= pos + 1


class _ForEnv:
    """Loop/assignment bindings visible to a name argument, resolved
    against literal iterables (position-aware for tuple targets)."""

    def __init__(self, fn: ast.AST, class_attrs: Dict[str, ast.AST]):
        self.bindings: Dict[str, List[str]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.For):
                self._bind_for(node, class_attrs)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                consts = _str_consts(node.value)
                if consts:
                    self.bindings.setdefault(
                        node.targets[0].id, []).extend(consts)

    def _bind_for(self, node: ast.For,
                  class_attrs: Dict[str, ast.AST]) -> None:
        it = node.iter
        if isinstance(it, ast.Attribute) and it.attr in class_attrs:
            it = class_attrs[it.attr]
        if not isinstance(it, (ast.Tuple, ast.List)):
            return
        if isinstance(node.target, ast.Name):
            vals = [s for e in it.elts for s in _str_consts(e)]
            if vals:
                self.bindings.setdefault(node.target.id, []).extend(vals)
        elif isinstance(node.target, ast.Tuple):
            names = [t.id if isinstance(t, ast.Name) else None
                     for t in node.target.elts]
            for idx, nm in enumerate(names):
                if nm is None:
                    continue
                vals = []
                for e in it.elts:
                    if isinstance(e, (ast.Tuple, ast.List)) \
                            and idx < len(e.elts):
                        s = _const_str(e.elts[idx])
                        if s is not None:
                            vals.append(s)
                if vals:
                    self.bindings.setdefault(nm, []).extend(vals)


def _str_consts(expr: ast.AST) -> List[str]:
    return [n.value for n in ast.walk(expr)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


# ----------------------------------------------------------- declarations

def _walk_qualnames(tree: ast.Module):
    """Yield (qualname, node) for every node, qualname = Class.method
    for nodes inside methods, else None-ish paths."""
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{cls.name}.{fn.name}", fn
        elif isinstance(cls, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield cls.name, cls


def declared_metrics(root: str, package: str = DEFAULT_PACKAGE
                     ) -> Tuple[Set[str], Set[Template]]:
    names: Set[str] = set()
    templates: Set[Template] = set()
    for rel, qual in _declaring(package):
        with open(os.path.join(root, rel)) as fh:
            tree = ast.parse(fh.read())
        scopes = []
        if qual is None:
            scopes = [tree]
        else:
            scopes = [fn for q, fn in _walk_qualnames(tree) if q == qual]
        for scope in scopes:
            env = _ForEnv(scope, {})
            for node in ast.walk(scope):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _METRIC_METHODS
                        and node.args):
                    continue
                arg = node.args[0]
                s = _const_str(arg)
                if s is not None:
                    names.add(s)
                elif isinstance(arg, ast.JoinedStr):
                    templates.add(_template_of(arg))
                elif isinstance(arg, ast.Name):
                    names.update(env.bindings.get(arg.id, ()))
    return names, templates


def declared_journal_kinds(root: str,
                           package: str = DEFAULT_PACKAGE) -> Set[str]:
    path = os.path.join(root, package, "telemetry", "journal.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        else:
            continue
        if isinstance(target, ast.Name) and target.id == "EVENT_SCHEMAS" \
                and isinstance(value, ast.Dict):
            return {k for k in (_const_str(kn) for kn in value.keys)
                    if k is not None}
    raise ValueError(f"no EVENT_SCHEMAS dict literal in {path}")


# ----------------------------------------------------------------- usages

def _class_attr_literals(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            out[stmt.targets[0].id] = stmt.value
    return out


def _param_index(fn: ast.FunctionDef, name: str) -> Optional[int]:
    for i, a in enumerate(fn.args.args):
        if a.arg == name:
            return i
    return None


def _resolve_arg(arg: ast.AST, env: _ForEnv,
                 fn: ast.AST, cls: Optional[ast.ClassDef]
                 ) -> Tuple[List[str], List[Template], bool]:
    """(constant names, templates, resolved?) for a name argument."""
    s = _const_str(arg)
    if s is not None:
        return [s], [], True
    if isinstance(arg, ast.JoinedStr):
        return [], [_template_of(arg)], True
    if isinstance(arg, ast.IfExp):
        consts = _str_consts(arg)
        if consts:
            return consts, [], True
    if isinstance(arg, ast.Name):
        bound = env.bindings.get(arg.id)
        if bound:
            return list(bound), [], True
        # parameter: collect literal arguments at same-class call sites
        if cls is not None and isinstance(fn, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)):
            idx = _param_index(fn, arg.id)
            if idx is not None:
                vals: List[str] = []
                for node in ast.walk(cls):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == fn.name):
                        continue
                    # positional (receiver absorbs `self`) or keyword
                    pos = idx - 1
                    if 0 <= pos < len(node.args):
                        v = _const_str(node.args[pos])
                        if v is not None:
                            vals.append(v)
                    for kw in node.keywords:
                        if kw.arg == arg.id:
                            v = _const_str(kw.value)
                            if v is not None:
                                vals.append(v)
                if vals:
                    return vals, [], True
    return [], [], False


def _iter_package_files(root: str, package: str) -> List[str]:
    out = []
    pkg = os.path.join(root, package)
    for dirpath, _, names in os.walk(pkg):
        for n in sorted(names):
            if n.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, n), root))
    return sorted(out)


def check_declared_names(root: str,
                         package: str = DEFAULT_PACKAGE) -> List[Finding]:
    """The two audits, package-wide; returns findings."""
    metric_names, metric_templates = declared_metrics(root, package)
    kinds = declared_journal_kinds(root, package)
    declaring = _declaring(package)
    findings: List[Finding] = []

    def metric_ok(name: str) -> bool:
        return name in metric_names or any(
            _template_matches_const(t, name) for t in metric_templates)

    for rel in _iter_package_files(root, package):
        with open(os.path.join(root, rel)) as fh:
            try:
                tree = ast.parse(fh.read())
            except SyntaxError:      # pragma: no cover - defensive
                continue
        # every Call in the file, tagged with its NEAREST enclosing
        # class/function — module-level wiring and classes nested inside
        # functions are covered, not just top-level method bodies
        scoped_calls: List[tuple] = []

        def _collect(node, cls, fn):
            for child in ast.iter_child_nodes(node):
                ncls, nfn = cls, fn
                if isinstance(child, ast.ClassDef):
                    ncls, nfn = child, None
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    nfn = child
                if isinstance(child, ast.Call) \
                        and isinstance(child.func, ast.Attribute):
                    scoped_calls.append((cls, fn, child))
                _collect(child, ncls, nfn)

        _collect(tree, None, None)
        envs: Dict[int, _ForEnv] = {}
        for cls, fn, node in scoped_calls:
            qual = (f"{cls.name}.{fn.name}" if cls is not None
                    and fn is not None
                    else fn.name if fn is not None
                    else cls.name if cls is not None else "<module>")
            if any(rel == drel and (dq is None or dq == qual)
                   for drel, dq in declaring):
                continue
            scope = fn if fn is not None else tree
            env = envs.get(id(scope))
            if env is None:
                attrs = (_class_attr_literals(cls)
                         if cls is not None else {})
                env = envs[id(scope)] = _ForEnv(scope, attrs)
            meth = node.func.attr
            if meth in _METRIC_METHODS and node.args:
                consts, tpls, ok = _resolve_arg(
                    node.args[0], env, fn, cls)
                if not ok:
                    findings.append(Finding(
                        "metric-name", rel, node.lineno, qual,
                        f"unresolved:{meth}",
                        f"{meth}(...) name argument is not "
                        "statically resolvable"))
                    continue
                for name in consts:
                    if not metric_ok(name):
                        findings.append(Finding(
                            "metric-name", rel, node.lineno, qual,
                            name,
                            f"{meth}({name!r}) is not pre-declared "
                            "by serving_metrics()"))
                for tpl in tpls:
                    # a usage template is declared when it IS a
                    # declared template, or when at least one
                    # declared constant instantiates it (the
                    # per-role gauges are declared as the three
                    # concrete names, used via one f-string)
                    if tpl not in metric_templates and not any(
                            _template_matches_const(tpl, n)
                            for n in metric_names):
                        findings.append(Finding(
                            "metric-name", rel, node.lineno, qual,
                            "*".join(tpl),
                            f"{meth}(f\"{'{…}'.join(tpl)}\") "
                            "matches no declared template"))
            elif meth == "emit" and node.args:
                recv_src = ""
                try:
                    recv_src = ast.unparse(node.func.value)
                except Exception:    # pragma: no cover
                    pass
                if "journal" not in recv_src:
                    continue
                consts, _, ok = _resolve_arg(
                    node.args[0], env, fn, cls)
                if not ok:
                    findings.append(Finding(
                        "journal-kind", rel, node.lineno, qual,
                        "unresolved:emit",
                        "journal.emit(...) kind is not "
                        "statically resolvable"))
                    continue
                for kind in consts:
                    if kind not in kinds:
                        findings.append(Finding(
                            "journal-kind", rel, node.lineno, qual,
                            kind,
                            f"emit({kind!r}) is not a kind in "
                            "EVENT_SCHEMAS"))
    return findings
