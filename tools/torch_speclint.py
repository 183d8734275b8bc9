"""torch_speclint — the static-analysis gate of the PyTorch/CUDA port, the
counterpart of tools/speclint.py (which lints the JAX package).

It imports nothing of jax or of the JAX package: the built-spec layer
builds the port's specs with the port's ``builder`` and checks their
containers against the port's ``utils/ssz/ssz_typing``. Two layers:

1. SOURCE checks over the port's .py files — the package
   ``consensus_specs_tpu_torch/``, its tests (``tests/test_torch_*.py``
   and ``tests/torch_*.py``), its tools (``tools/torch_*.py``) and
   ``chip_smoke.py`` (symtable-based, pyflakes-class):
   - undefined names: a symbol referenced in any scope that is neither
     local, nor enclosing, nor module-level, nor a builtin. This is the
     bug class that silently breaks exec-layered namespaces.
   - unused imports (module scope; `__init__.py` re-export modules and
     star-importing files are exempt, `# noqa` suppresses a line).
   - duplicate definitions (pyflakes F811): two `def`/`class` statements
     with the same name in the SAME statement body (module, class, or
     function) — the later silently shadows the earlier. Branch-split
     redefinitions (if/else, try/except) live in different body lists and
     are not flagged; `@x.setter`-style attribute-decorated redefs are
     exempt.

2. BUILT-SPEC checks over every (fork, preset) module the port's builder
   emits:
   - every name a spec function's code references (co_names, incl. nested
     code objects) must resolve in the built module or builtins;
   - every function annotation must resolve (typing.get_type_hints);
   - every SSZ container field type must be a real View class;
   - every direct call from a spec function to another function in the
     built namespace must BIND against the callee's signature (arity +
     keyword validity, inspect.signature.bind).

Usage: python tools/torch_speclint.py [--source-only]
Exit status 0 = clean. Any finding prints `path:line: message` and fails.
The findings on a given namespace or source are tools/speclint.py's
(tests/test_torch_speclint.py holds them equal).
"""
import ast
import builtins
import os
import sys
import symtable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_BUILTINS = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__path__", "__class__",
}

PACKAGE = "consensus_specs_tpu_torch"
# (directory, file-name prefixes) of the port's tests and tools
PORT_FILES = (("tests", ("test_torch_", "torch_")), ("tools", ("torch_",)))
SKIP_DIRS = {"__pycache__", "_build"}


def _py_files():
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, PACKAGE)):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for root, prefixes in PORT_FILES:
        for f in sorted(os.listdir(os.path.join(REPO, root))):
            if f.endswith(".py") and f.startswith(prefixes):
                yield os.path.join(REPO, root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _noqa_lines(src: str):
    return {
        i + 1 for i, line in enumerate(src.splitlines()) if "noqa" in line
    }


def _walk_tables(table):
    yield table
    for child in table.get_children():
        yield from _walk_tables(child)


def _collect_defined_through(table, defined):
    """Names visible to children scopes: everything assigned/imported/
    parameter/function-or-class-defined in this table plus ancestors."""
    out = set(defined)
    for sym in table.get_symbols():
        if sym.is_assigned() or sym.is_imported() or sym.is_parameter() or sym.is_namespace():
            out.add(sym.get_name())
    return out


def check_duplicate_defs(tree, rel: str, noqa):
    """F811-class sweep: same-name `def`/`class` statements in one
    statement body. Bodies are scanned per-list, so `if`/`try` branch
    variants never collide; a redefinition whose decorator is an attribute
    access (`@prop.setter`, `@fn.register`) is the accumulator idiom and
    is exempt."""
    findings = []
    for node in ast.walk(tree):
        # every statement list is its own scan scope: body, else-branches
        # (If/For/While/Try orelse) and finally blocks — a dup WITHIN one
        # list shadows; defs split ACROSS lists are branch variants
        for body in (getattr(node, "body", None),
                     getattr(node, "orelse", None),
                     getattr(node, "finalbody", None)):
            if not isinstance(body, list):
                continue
            seen = {}
            for stmt in body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    continue
                first = seen.get(stmt.name)
                # the accumulator idiom only: a decorator rooted at the
                # redefined name ITSELF (@x.setter / @x.register for def x).
                # Any other dotted decorator (@pytest.mark.slow, ...) is
                # not an exemption — two decorated test defs still shadow.
                self_decorated = any(
                    isinstance(d, ast.Attribute)
                    and isinstance(d.value, ast.Name)
                    and d.value.id == stmt.name
                    for d in stmt.decorator_list
                )
                if (first is not None and not self_decorated
                        and stmt.lineno not in noqa):
                    findings.append(
                        f"{rel}:{stmt.lineno}: duplicate definition of "
                        f"'{stmt.name}' (first defined at line {first}; "
                        "the later definition silently shadows it)"
                    )
                seen.setdefault(stmt.name, stmt.lineno)
    return findings


def check_source_file(path: str):
    findings = []
    src = open(path).read()
    rel = os.path.relpath(path, REPO)
    # specsrc files are exec-LAYERED into one namespace at build time, so
    # cross-file references are the design, not a bug; the built-spec layer
    # below is their real checker
    in_specsrc = rel.replace(os.sep, "/").startswith(PACKAGE + "/specsrc/")
    try:
        tree = ast.parse(src)
        top = symtable.symtable(src, rel, "exec")
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]

    has_star = any(
        isinstance(n, ast.ImportFrom) and any(a.name == "*" for a in n.names)
        for n in ast.walk(tree)
    )
    noqa = _noqa_lines(src)

    # map name -> first use line (approximate, for reporting)
    use_lines = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            use_lines.setdefault(node.id, node.lineno)

    module_names = _collect_defined_through(top, set())

    # duplicate-definition sweep runs for EVERY file (specsrc included:
    # fork layering overrides across files by design, but a redefinition
    # within one module body is always a silent shadow)
    findings += check_duplicate_defs(tree, rel, noqa)

    if not has_star and not in_specsrc:
        # undefined-name sweep: FREE (global-implicit) symbols in any scope
        # must exist at module level or be builtins
        for table in _walk_tables(top):
            for sym in table.get_symbols():
                name = sym.get_name()
                if not sym.is_referenced():
                    continue
                if sym.is_local() or sym.is_parameter():
                    continue
                if sym.is_free():
                    continue  # closure binding: defined in an enclosing scope
                if name in module_names or name in _BUILTINS:
                    continue
                line = use_lines.get(name, 1)
                if line in noqa:
                    continue
                findings.append(
                    f"{rel}:{line}: undefined name '{name}' "
                    f"(scope {table.get_name()})"
                )

        # unused-import sweep: an imported name never LOADED anywhere in
        # the file (module scope or nested) and not re-exported via __all__
        if os.path.basename(path) != "__init__.py":
            exported = set()
            for n in ast.walk(tree):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Name) and t.id == "__all__":
                            exported = {
                                getattr(e, "value", None)
                                for e in getattr(n.value, "elts", [])
                            }
            for node in ast.walk(tree):
                if not isinstance(node, (ast.Import, ast.ImportFrom)):
                    continue
                if node.lineno in noqa:
                    continue
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    if name == "*" or name in use_lines or name in exported:
                        continue
                    if name == "annotations":  # from __future__
                        continue
                    findings.append(
                        f"{rel}:{node.lineno}: unused import '{name}'"
                    )
    return findings


# ---------------------------------------------------------------------------
# built-spec checks
# ---------------------------------------------------------------------------


def _function_names(fn):
    """All GLOBAL names a function's code loads (dis-level, so attribute
    accesses and locals are excluded), nested code objects included."""
    import dis

    out = set()
    stack = [fn.__code__]
    while stack:
        code = stack.pop()
        for ins in dis.get_instructions(code):
            if ins.opname in ("LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL"):
                out.add(ins.argval)
        stack.extend(c for c in code.co_consts if hasattr(c, "co_names"))
    return out


def check_call_signatures(ns: dict, where: str):
    """For every function whose home namespace is ``ns``, parse its source
    and check each direct ``name(...)`` call whose callee resolves to a
    plain Python function in ``ns``: the written-out arguments must bind
    against the callee's signature. Call sites using *args/**kwargs, and
    callees that aren't plain functions (classes, builtins, SSZ types —
    different calling conventions), are skipped."""
    import inspect
    import textwrap

    findings = []
    for name in sorted(ns):
        fn = ns[name]
        if not (callable(fn) and hasattr(fn, "__code__")):
            continue
        if getattr(fn, "__globals__", None) is not ns:
            continue  # imported helper: its own module's lint covers it
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        except (OSError, SyntaxError, TypeError):
            continue  # source not recoverable (exec'd without a file)
        local_names = set(fn.__code__.co_varnames)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
                continue
            if node.func.id in local_names:
                continue  # shadowed by a local: not the ns function
            callee = ns.get(node.func.id)
            if not inspect.isfunction(callee):
                continue
            if any(isinstance(a, ast.Starred) for a in node.args) or any(
                kw.arg is None for kw in node.keywords
            ):
                continue  # splatted call: arity unknowable statically
            try:
                inspect.signature(callee).bind(
                    *[None] * len(node.args),
                    **{kw.arg: None for kw in node.keywords},
                )
            except TypeError as e:
                findings.append(
                    f"{where}: {name} line {node.lineno}: call to "
                    f"{node.func.id}() does not bind: {e}"
                )
    return findings


def check_built_spec(fork: str, preset: str):
    import typing

    from consensus_specs_tpu_torch.builder import build_spec_module
    from consensus_specs_tpu_torch.utils.ssz.ssz_typing import Container, View

    findings = []
    mod = build_spec_module(fork, preset)
    ns = vars(mod)
    where = f"<built {fork}/{preset}>"

    for name in sorted(ns):
        obj = ns[name]
        if callable(obj) and hasattr(obj, "__code__"):
            if getattr(obj, "__globals__", None) is not ns:
                continue  # imported helper: resolves in its OWN module
            for ref in sorted(_function_names(obj)):
                if ref not in ns and ref not in _BUILTINS:
                    findings.append(
                        f"{where}: function {name} references undefined '{ref}'"
                    )
            try:
                typing.get_type_hints(obj, ns)
            except Exception as e:
                findings.append(
                    f"{where}: function {name} has unresolvable annotations: {e}"
                )
        elif isinstance(obj, type) and issubclass(obj, Container) and obj is not Container:
            for fname, ftyp in obj.fields().items():
                if not (isinstance(ftyp, type) and issubclass(ftyp, View)):
                    findings.append(
                        f"{where}: container {name}.{fname} has non-View type {ftyp!r}"
                    )
    findings += check_call_signatures(ns, where)
    return findings


def main() -> int:
    findings = []
    for path in _py_files():
        findings += check_source_file(path)

    if "--source-only" not in sys.argv:
        from consensus_specs_tpu_torch.builder import IMPLEMENTED_FORKS

        for fork in IMPLEMENTED_FORKS:
            for preset in ("minimal", "mainnet"):
                findings += check_built_spec(fork, preset)

    for f in findings:
        print(f)
    print(f"torch_speclint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
