"""Project-invariant lint, the port's copy of the JAX package's
``analysis/lint.py``: the project's conventions encoded as AST rules over
the whole package (catalog + rationale in the repo's ANALYSIS.md; run
via ``python -m librdkafka_tpu_torch.analysis lint``).

Rules (ids are stable; suppress a line with ``# lint: ok <rule>``):

  sleep-poll       client/ must wait on condvars, never sleep-poll
                   (test_0120's contract; SyncReply replaced the
                   rounds-2/3 sleep loops)
  conf-prop        every conf Prop is validated (int/float: range or
                   validator; aliases inherit the target's) and has a
                   row in the port's CONFIGURATION.md (the generated
                   docs and the table must not drift)
  trace-guard      trace hook sites (evt/complete/instant) sit behind
                   an ``if <trace>.enabled:`` attr check or a guard
                   var assigned from one — the <2% disabled-overhead
                   contract
  bare-except      no ``except:`` — it eats KeyboardInterrupt/
                   SystemExit and hides real faults in thread loops
  chaos-random     chaos/ and fleet/ randomness comes only from a
                   seeded ``random.Random`` (schedule or traffic
                   plan) — module-level random breaks same-seed
                   replay (CHAOS.md, FLEET.md)
  thread-name      every thread is named so the conftest leak fixture
                   can claim it (engine/sockem/chaos-sched matching)
  manual-acquire   no manual ``.acquire()`` — a raise between acquire
                   and release leaks the lock forever; use ``with``
  lock-factory     lock sites in client/, ops/engine.py, ops/gpu.py,
                   mock/, chaos/ and fleet/ create primitives through
                   analysis.locks so lockdep can instrument them
  shared-state     classes in the same scoped layers that start
                   threads or create factory locks must declare their
                   cross-thread mutable attributes via
                   analysis.races (shared()/register_slots()/
                   shared_dict()/shared_list()/shared_counter()) so
                   the lockset detector can see them — or carry a
                   class-line pragma with a written justification

The linter is intentionally lexical where data-flow would be needed
for perfection (e.g. trace-guard accepts ``if t0:`` when ``t0`` was
assigned from ``trace.now() if trace.enabled else 0`` in the same
function) — the goal is catching drift in review, not soundness.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Optional

#: module aliases accepted as "the tracer" by trace-guard
_TRACE_NAMES = {"trace", "_trace", "_tr"}
_TRACE_HOOKS = {"evt", "complete", "instant"}
_LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: paths (relative to the package root, / separators) under the
#: lock-factory rule — the layers lockdep instruments
_FACTORY_SCOPE = ("client/", "mock/", "chaos/", "fleet/", "ops/engine.py",
                  "ops/gpu.py")

#: layers whose randomness must come from a seeded Random (the
#: replay-from-seed contract: CHAOS.md for schedules, FLEET.md for
#: traffic plans and worker sampling)
_SEEDED_RANDOM_SCOPE = ("chaos/", "fleet/")

#: calls that count as a shared-state declaration (analysis/races.py)
_SHARED_DECLS = {"shared", "shared_dict", "shared_list",
                 "shared_counter", "register_slots"}

#: files whose job exempts them from specific rules
_RULE_EXEMPT = {
    "manual-acquire": ("analysis/lockdep.py",),
    "trace-guard": ("obs/trace.py",),
    "lock-factory": ("analysis/",),
    "shared-state": ("analysis/",),
}

_PRAGMA = re.compile(r"#\s*lint:\s*ok\s+([a-z-]+(?:\s*,\s*[a-z-]+)*)")


@dataclass
class Finding:
    file: str
    line: int
    rule: str
    msg: str

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.rule}] {self.msg}"


def _pragmas(src: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(src.splitlines(), 1):
        m = _PRAGMA.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")}
    return out


def _exempt(rule: str, relpath: str) -> bool:
    return any(relpath.startswith(p) or relpath == p
               for p in _RULE_EXEMPT.get(rule, ()))


class _GuardAttrs(ast.NodeVisitor):
    """Prepass: attribute names that carry a trace-guard truth value —
    assigned from ``<trace>.now()``, from a guard-conditional IfExp, or
    under an ``if <x>.enabled:`` block (e.g. ``self.t_crc_ns``) — so
    ``if self.t_crc_ns:`` counts as a guard downstream."""

    def __init__(self):
        self.attrs: set[str] = set()
        self._guard_names: set[str] = set()
        self._depth = 0

    @staticmethod
    def _guardish(node, names) -> bool:
        if isinstance(node, ast.Attribute) and node.attr == "enabled":
            return True
        if isinstance(node, ast.Name) and node.id in names:
            return True
        return False

    def _is_now_call(self, node) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "now"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in _TRACE_NAMES)

    def visit_If(self, node):
        guarded = self._guardish(node.test, self._guard_names)
        if guarded:
            self._depth += 1
        for n in node.body:
            self.visit(n)
        if guarded:
            self._depth -= 1
        for n in node.orelse:
            self.visit(n)

    def visit_Assign(self, node):
        v = node.value
        carries = (self._depth > 0 and self._is_now_call(v)) or (
            isinstance(v, ast.IfExp)
            and self._guardish(v.test, self._guard_names)) or (
            isinstance(v, ast.Name) and v.id in self._guard_names)
        if carries:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._guard_names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    self.attrs.add(t.attr)
        self.generic_visit(node)


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, guard_attrs: Optional[set] = None):
        self.relpath = relpath
        self.findings: list[Finding] = []
        self._loop_depth = 0
        # per-function names assigned from `X if <trace>.enabled else Y`
        self._guard_vars: list[set[str]] = [set()]
        self._guard_attrs = guard_attrs or set()
        self._if_guard_depth = 0

    def _add(self, node, rule: str, msg: str):
        self.findings.append(Finding(self.relpath, node.lineno, rule, msg))

    # ---------------------------------------------------- helpers --
    @staticmethod
    def _is_enabled_attr(node) -> bool:
        """``<name>.enabled`` where <name> is a trace/lockdep alias —
        or any ``X.enabled`` attribute (other modules use the same
        pattern; a stray .enabled guard is not worth a false
        positive)."""
        return isinstance(node, ast.Attribute) and node.attr == "enabled"

    def _test_is_guard(self, test) -> bool:
        """Accepts `X.enabled`, boolean ops containing it, and bare
        names assigned from an enabled-conditional in this function."""
        if self._is_enabled_attr(test):
            return True
        if isinstance(test, ast.Name) and test.id in self._guard_vars[-1]:
            return True
        if isinstance(test, ast.Attribute) and test.attr in self._guard_attrs:
            return True
        if isinstance(test, ast.BoolOp):
            return any(self._test_is_guard(v) for v in test.values)
        if isinstance(test, ast.UnaryOp):
            return self._test_is_guard(test.operand)
        return False

    # ------------------------------------------------- structure --
    def _visit_fn(self, node):
        self._guard_vars.append(set())
        self.generic_visit(node)
        self._guard_vars.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Assign(self, node):
        # collect guard vars: t0 = trace.now() if trace.enabled else 0
        v = node.value
        if isinstance(v, ast.IfExp) and self._test_is_guard(v.test):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._guard_vars[-1].add(t.id)
        self.generic_visit(node)

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = _visit_loop
    visit_For = _visit_loop

    def visit_If(self, node):
        guarded = self._test_is_guard(node.test)
        if guarded:
            self._if_guard_depth += 1
        for n in node.body:
            self.visit(n)
        if guarded:
            self._if_guard_depth -= 1
        for n in node.orelse:
            self.visit(n)

    def visit_ExceptHandler(self, node):
        if node.type is None and not _exempt("bare-except", self.relpath):
            self._add(node, "bare-except",
                      "bare `except:` — name the exceptions (a bare "
                      "clause eats SystemExit/KeyboardInterrupt)")
        self.generic_visit(node)

    # ----------------------------------------------------- calls --
    def visit_Call(self, node):
        f = node.func
        # sleep-poll: time.sleep inside a loop, client/ only
        if (self.relpath.startswith("client/") and self._loop_depth > 0
                and isinstance(f, ast.Attribute) and f.attr == "sleep"
                and isinstance(f.value, ast.Name) and f.value.id == "time"
                and not _exempt("sleep-poll", self.relpath)):
            self._add(node, "sleep-poll",
                      "time.sleep in a client/ loop — wait on a "
                      "Condition/SyncReply instead (test_0120)")
        # trace-guard: unguarded trace hook call
        if (isinstance(f, ast.Attribute) and f.attr in _TRACE_HOOKS
                and isinstance(f.value, ast.Name)
                and f.value.id in _TRACE_NAMES
                and self._if_guard_depth == 0
                and not _exempt("trace-guard", self.relpath)):
            self._add(node, "trace-guard",
                      f"trace hook {f.value.id}.{f.attr}() outside an "
                      f"`if {f.value.id}.enabled:` guard (the "
                      "overhead contract)")
        # chaos-random: module-level random in chaos/ or fleet/
        if (self.relpath.startswith(_SEEDED_RANDOM_SCOPE)
                and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "random" and f.attr != "Random"
                and not _exempt("chaos-random", self.relpath)):
            self._add(node, "chaos-random",
                      f"random.{f.attr}() in {self.relpath.split('/')[0]}/ "
                      "— draw from the schedule's/plan's seeded Random "
                      "so replay_key replays (CHAOS.md, FLEET.md)")
        # thread-name: threading.Thread(...) without name=
        if (isinstance(f, ast.Attribute) and f.attr in ("Thread", "Timer")
                and isinstance(f.value, ast.Name)
                and f.value.id == "threading"
                and not any(k.arg == "name" for k in node.keywords)
                and not _exempt("thread-name", self.relpath)):
            self._add(node, "thread-name",
                      "unnamed thread — pass name=... so the conftest "
                      "leak fixture can claim it")
        # thread-name (subclass form): super().__init__ without name=
        # is covered by the same rule when the class derives Thread —
        # kept lexical: super().__init__(...) inside a class whose
        # bases mention Thread is checked in _check_thread_subclass
        # manual-acquire
        if (isinstance(f, ast.Attribute) and f.attr == "acquire"
                and not _exempt("manual-acquire", self.relpath)):
            self._add(node, "manual-acquire",
                      "manual .acquire() — an exception before "
                      "release() leaks the lock; use `with`")
        # lock-factory: direct primitive creation in scoped layers
        if (any(self.relpath.startswith(p) for p in _FACTORY_SCOPE)
                and isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS
                and isinstance(f.value, ast.Name)
                and f.value.id == "threading"
                and not _exempt("lock-factory", self.relpath)):
            self._add(node, "lock-factory",
                      f"threading.{f.attr}() in a lockdep-scoped layer "
                      "— create it via analysis.locks.new_"
                      f"{'cond' if f.attr == 'Condition' else f.attr.lower()}"
                      "(name) so the checker can instrument it")
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        # Thread subclasses must pass name= to super().__init__
        derives_thread = any(
            (isinstance(b, ast.Attribute) and b.attr == "Thread")
            or (isinstance(b, ast.Name) and b.id == "Thread")
            for b in node.bases)
        if derives_thread and not _exempt("thread-name", self.relpath):
            for n in ast.walk(node):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "__init__"
                        and isinstance(n.func.value, ast.Call)
                        and isinstance(n.func.value.func, ast.Name)
                        and n.func.value.func.id == "super"
                        and not any(k.arg == "name" for k in n.keywords)):
                    self._add(n, "thread-name",
                              "Thread subclass __init__ without "
                              "name= — the conftest leak fixture "
                              "cannot claim it")
        self.generic_visit(node)


# ------------------------------------------------- shared-state rule --
def _call_name(node) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _lint_shared_state(tree: ast.AST, relpath: str) -> list[Finding]:
    """Concurrent classes must declare their cross-thread mutable
    attributes to the lockset detector (analysis/races.py).  A class
    in the lockdep-scoped layers "is concurrent" when it starts a
    thread (threading.Thread/Timer call, or a Thread base) or creates
    a factory lock; it "declares" when its body calls shared()/
    shared_dict()/shared_list()/shared_counter(), or a module-level
    register_slots(ClassName, ...) names it.  Suppress with a
    ``# lint: ok shared-state`` pragma ON THE CLASS LINE plus a
    written justification — the pragma is the judged-exception path,
    exactly like the runtime detector's ``relaxed=True``."""
    if not any(relpath.startswith(p) for p in _FACTORY_SCOPE):
        return []
    # prepass: classes declared via register_slots(Cls, ...)
    slot_declared: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and _call_name(node) == "register_slots"
                and node.args and isinstance(node.args[0], ast.Name)):
            slot_declared.add(node.args[0].id)
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        derives_thread = any(
            (isinstance(b, ast.Attribute) and b.attr == "Thread")
            or (isinstance(b, ast.Name) and b.id == "Thread")
            for b in node.bases)
        starts_thread = derives_thread
        makes_lock = False
        declares = node.name in slot_declared
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            cn = _call_name(n)
            if cn in ("Thread", "Timer") and isinstance(
                    n.func, ast.Attribute) and isinstance(
                    n.func.value, ast.Name) and \
                    n.func.value.id == "threading":
                starts_thread = True
            elif cn in ("new_lock", "new_rlock", "new_cond"):
                makes_lock = True
            elif cn in _SHARED_DECLS:
                declares = True
        if (starts_thread or makes_lock) and not declares:
            what = ("starts threads" if starts_thread
                    else "creates factory locks")
            out.append(Finding(
                relpath, node.lineno, "shared-state",
                f"class {node.name} {what} but declares no shared "
                "state — declare cross-thread mutable attributes via "
                "analysis.races (shared()/register_slots()/shared_*()) "
                "so the lockset detector sees them, or pragma the "
                "class line with a written justification"))
    return out


# --------------------------------------------------- conf-prop rule --
def _lint_conf_props(tree: ast.AST, relpath: str,
                     doc_names: Optional[set] = None) -> list[Finding]:
    """conf.py's PROPERTIES table: int/float Props need a range or
    validator (aliases inherit the target's), non-hidden Props need a
    CONFIGURATION.md row.  ``doc_names=None`` skips the doc check
    (fixture mode)."""
    out: list[Finding] = []
    props = None
    for node in ast.walk(tree):
        target = None
        if isinstance(node, ast.Assign) and node.targets:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if (target is not None and isinstance(target, ast.Name)
                and target.id == "PROPERTIES"):
            props = node.value
            break
    if props is None:
        return out
    for c in ast.walk(props):
        if not (isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                and c.func.id in ("_p", "Prop")):
            continue
        if len(c.args) < 3 or not isinstance(c.args[0], ast.Constant):
            continue
        name = c.args[0].value
        ptype = c.args[2].value if isinstance(c.args[2], ast.Constant) \
            else None
        kw = {k.arg: k.value for k in c.keywords}
        is_alias = "alias" in kw
        hidden = (isinstance(kw.get("hidden"), ast.Constant)
                  and kw["hidden"].value)
        if (ptype in ("int", "float") and not is_alias
                and not any(k in kw for k in ("vmin", "vmax",
                                              "validator"))):
            out.append(Finding(
                relpath, c.lineno, "conf-prop",
                f"Prop {name!r}: {ptype} without vmin/vmax or "
                "validator — a bad value must fail at set() time"))
        if doc_names is not None and not hidden and name not in doc_names:
            out.append(Finding(
                relpath, c.lineno, "conf-prop",
                f"Prop {name!r} has no CONFIGURATION.md row — "
                "regenerate: python -m librdkafka_tpu_torch.client.conf "
                "> librdkafka_tpu_torch/CONFIGURATION.md"))
    return out


def _doc_names(root: str) -> Optional[set]:
    """Property names of the port's own CONFIGURATION.md (in the package
    root, beside client/)."""
    md = os.path.join(root, "CONFIGURATION.md")
    if not os.path.exists(md):
        return None
    names = set()
    with open(md) as f:
        for line in f:
            if " | " in line and not line.startswith(("Property", "---")):
                names.add(line.split(" | ")[0].strip().strip("`"))
    return names


# ------------------------------------------------------ entry points --
def lint_source(src: str, relpath: str,
                doc_names: Optional[set] = None) -> list[Finding]:
    """Lint one file's source; ``relpath`` is package-root-relative
    with / separators (it scopes the path-dependent rules)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(relpath, e.lineno or 0, "syntax", str(e))]
    pre = _GuardAttrs()
    pre.visit(tree)
    v = _Visitor(relpath, pre.attrs)
    v.visit(tree)
    findings = v.findings
    if not _exempt("shared-state", relpath):
        findings += _lint_shared_state(tree, relpath)
    if relpath == "client/conf.py":
        findings += _lint_conf_props(tree, relpath, doc_names)
    pragmas = _pragmas(src)
    return [f for f in findings
            if f.rule not in pragmas.get(f.line, ())]


def lint_package(root: Optional[str] = None) -> list[Finding]:
    """Lint every .py file under the package root (default: this
    package's parent, i.e. librdkafka_tpu_torch/)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    doc_names = _doc_names(root)
    findings: list[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                src = f.read()
            findings += lint_source(src, rel, doc_names)
    findings.sort(key=lambda f: (f.file, f.line))
    return findings


def main(argv: Optional[list] = None) -> int:
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    root = argv[0] if argv else None
    findings = lint_package(root)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"lint: {n} finding(s)" if n else "lint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
