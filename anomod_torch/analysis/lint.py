"""Linter core: file walking, suppression syntax, baseline semantics.

Counterpart of ``anomod/analysis/lint.py``, held to it by
``tests/test_torch_contracts.py``: the same directive grammar (one
``anomod-lint:`` comment serves both trees), the same baseline
semantics, the same rule catalog :data:`RULES` (``lint --rules`` prints
the bytes ``anomod lint --rules`` prints, so ``docs/CONTRACTS.md`` is
the catalog of both).  What differs is what it walks: the port's scan
set is ``anomod_torch/**/*.py`` plus ``chip_smoke.py`` (the port's
driver, as ``bench.py`` is the JAX package's), its env corpus
``anomod_torch/config.py``, ``README.md`` and ``docs/*.md``, and its
baseline ``anomod_torch/analysis/lint_baseline.json``.

The framework pieces live here; the contract knowledge lives in
``anomod_torch.analysis.rules`` (AST rule families) and
``anomod_torch.analysis.parity`` (the import-free parity-surface audit).

Suppression contract
--------------------

A finding is suppressed by a directive on ITS line, or by a directive-
only line directly above the statement it blesses (the suppression
covers that one statement — a compound statement's body included)::

    val = time.time()  # anomod-lint: disable=D101 — forensic timestamp

    # anomod-lint: disable=S301 — fused gather reads through pool.gather_window
    return reps[0]._runner.pool.gather_window(slots, cols)

``disable-file=RULE`` anywhere in the file suppresses the rule for the
whole file.  The reason (after ``—``, ``--`` or ``:``) is REQUIRED:
a bare disable is itself a finding (``LINT000``) that cannot be
suppressed — the directive's job is to leave a reviewable why behind.

Baseline contract
-----------------

``anomod_torch/analysis/lint_baseline.json`` holds finding keys accepted
at gate time.  The gate fails only on findings NOT in the baseline, so
adopting a new rule never blocks the tree — but the baseline may only
shrink: a stale entry (baselined finding that no longer fires) is
reported so ``--update-baseline`` ratchets it out.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

#: rule-id grammar (also the directive parser's token shape)
_RULE_ID = re.compile(r"^(LINT|[DESPLC])\d{3}$")

_DIRECTIVE_HINT = re.compile(r"#\s*anomod-lint:")
_DIRECTIVE = re.compile(
    r"#\s*anomod-lint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[A-Z]+\d{3}(?:\s*,\s*[A-Z]+\d{3})*)"
    r"(?:\s*(?:—|--|:)\s*(?P<reason>.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One enforced contract (docs/CONTRACTS.md renders this table)."""
    id: str
    family: str
    synopsis: str
    #: which shipped bug (or prose contract) motivated mechanizing it
    motivation: str


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    @property
    def key(self) -> str:
        """Baseline identity.  Deliberately line-numbered: a baselined
        finding that MOVES re-fires, which is the conservative side."""
        return f"{self.rule}|{self.path}|{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _comment_lines(source: str):
    """(line_number, comment_text) for every REAL comment token.

    Tokenizing (not splitlines) is what keeps directive-looking text
    inside string literals and docstrings — e.g. a doc example of the
    suppression syntax — from being parsed as a live directive: a
    malformed one would raise an unsuppressable LINT000 with no escape
    but rewriting the string.  Falls back to a whole-line scan only
    when the source does not tokenize (it already parsed as AST, so
    this is vestigial caution)."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                # standalone == nothing but whitespace before the `#`
                standalone = not tok.line[:tok.start[1]].strip()
                yield tok.start[0], tok.string, standalone
    except (tokenize.TokenError, IndentationError):
        for i, text in enumerate(source.splitlines(), start=1):
            yield i, text, text.strip().startswith("#")


class Suppressions:
    """Parsed ``anomod-lint`` directives of one file."""

    def __init__(self, source: str, path: str):
        self.by_line: Dict[int, Tuple[Tuple[str, ...], str]] = {}
        self.standalone: Dict[int, Tuple[Tuple[str, ...], str]] = {}
        self.file_wide: Dict[str, str] = {}
        self.errors: List[Finding] = []
        for i, text, standalone in _comment_lines(source):
            if not _DIRECTIVE_HINT.search(text):
                continue
            m = _DIRECTIVE.search(text)
            if not m:
                self.errors.append(Finding(
                    "LINT000", path, i,
                    "malformed suppression directive — syntax: "
                    "# anomod-" "lint: disable=D101 — reason"))
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            reason = (m.group("reason") or "").strip()
            bad = [r for r in rules if not _RULE_ID.match(r)]
            if bad or not rules:
                self.errors.append(Finding(
                    "LINT000", path, i,
                    f"malformed suppression (unknown rule id "
                    f"{', '.join(bad) or '<none>'}) — syntax: "
                    "# anomod-" "lint: disable=D101 — reason"))
                continue
            if not reason:
                self.errors.append(Finding(
                    "LINT000", path, i,
                    "suppression without a reason — write "
                    "# anomod-" "lint: disable="
                    f"{','.join(rules)} — <why this exception is safe>"))
                continue
            if m.group("scope"):
                for r in rules:
                    self.file_wide[r] = reason
            else:
                self.by_line[i] = (rules, reason)
                # a directive-ONLY line suppresses the statement below
                # it; ModuleContext widens this to the statement's full
                # extent once the tree is parsed
                if standalone:
                    self.standalone[i] = (rules, reason)

    def match(self, rule: str, line: int) -> Optional[str]:
        """The reason when ``rule`` at ``line`` is suppressed."""
        if rule in self.file_wide:
            return self.file_wide[rule]
        got = self.by_line.get(line)
        if got and rule in got[0]:
            return got[1]
        return None


class ModuleContext:
    """Everything a rule needs about one file: the parsed tree (with
    parent links), the source, the path that decides rule scoping, and
    the env-contract coverage corpus."""

    def __init__(self, source: str, path: str, corpus: str = ""):
        self.source = source
        self.path = path.replace("\\", "/")
        self.corpus = corpus
        self.tree = ast.parse(source)
        # ONE tree traversal: node list (every rule iterates this
        # instead of re-walking — 8 walks/file made the repo lint take
        # seconds), parent links, statement extents and import aliases
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.nodes: List[ast.AST] = [self.tree]
        #: head-alias -> real module name ("np" -> "numpy",
        #: "_time" -> "time", "pc" -> "time.perf_counter")
        self.imports: Dict[str, str] = {}
        ends: Dict[int, int] = {}
        i = 0
        while i < len(self.nodes):
            node = self.nodes[i]
            i += 1
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                self.nodes.append(child)
            if isinstance(node, ast.stmt):
                end = getattr(node, "end_lineno", None) or node.lineno
                ends[node.lineno] = max(ends.get(node.lineno,
                                                 node.lineno), end)
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        # `import a.b` binds the ROOT name `a`, and
                        # that name refers to module `a` — mapping it
                        # to "a.b" would make resolve() spell
                        # a.b.<attr> as "a.b.b.<attr>" and silently
                        # skip the D103/E2xx match tables
                        root = a.name.split(".")[0]
                        self.imports[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self.suppressions = Suppressions(source, self.path)
        # widen each directive-only line to the full extent of the
        # statement starting below it (a compound statement's body
        # included): the directive blesses ONE reviewable construct,
        # e.g. the engine's fused-gather branch
        for ln0, entry in self.suppressions.standalone.items():
            for ln in range(ln0 + 1, ends.get(ln0 + 1, ln0 + 1) + 1):
                self.suppressions.by_line.setdefault(ln, entry)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression with the head import-alias
        resolved ("np.random.default_rng" -> "numpy.random.default_rng");
        None when the head is not a known module or builtin."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.imports.get(node.id)
        if head is None:
            if parts:            # obj.attr where obj is not a module
                return None
            head = node.id       # bare name: builtin candidate
        parts.append(head)
        return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# repo walking
# ---------------------------------------------------------------------------

def repo_root() -> Path:
    """This checkout's root (anomod_torch/analysis/lint.py -> repo)."""
    return Path(__file__).resolve().parents[2]


def scan_files(root: Path) -> List[Path]:
    """The lint scan set: the port's package and its driver
    (``chip_smoke.py``).  tests/ is deliberately excluded —
    tests/lint_fixtures/ holds must-trip corpora."""
    files = []
    driver = root / "chip_smoke.py"
    if driver.is_file():
        files.append(driver)
    files += sorted((root / "anomod_torch").rglob("*.py"))
    return [p for p in files if p.is_file()]


def env_corpus(root: Path) -> str:
    """The env-contract coverage corpus — the same definition
    ``anomod_torch.analysis.contracts --env`` uses: the port's Config
    module plus every markdown doc."""
    parts = []
    for p in [root / "anomod_torch" / "config.py", root / "README.md",
              *sorted((root / "docs").glob("*.md"))]:
        if p.is_file():
            parts.append(p.read_text(errors="replace"))
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str, corpus: str = "") -> List[Finding]:
    """Lint one source blob under the scoping identity ``path`` (tests
    hand fixture files a pretend canonical/seam/locked path).  Returns
    EVERY finding; suppressed ones carry ``suppressed=True`` and the
    directive's reason."""
    from anomod_torch.analysis import rules as _rules
    ctx = ModuleContext(source, path, corpus)
    raw: List[Finding] = []
    seen: set = set()
    for rule_fn in _rules.ALL_CHECKS:
        for f in rule_fn(ctx):
            if f.key not in seen:       # one finding per (rule, line)
                seen.add(f.key)
                raw.append(f)
    out = list(ctx.suppressions.errors)     # LINT000: never suppressible
    for f in raw:
        reason = ctx.suppressions.match(f.rule, f.line)
        if reason is not None:
            f = dataclasses.replace(f, suppressed=True, reason=reason)
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_repo(root: Optional[Path] = None,
              paths: Optional[Iterable[Path]] = None) -> List[Finding]:
    """Lint the whole scan set (or an explicit file list)."""
    root = Path(root) if root is not None else repo_root()
    corpus = env_corpus(root)
    findings: List[Finding] = []
    for p in (list(paths) if paths is not None else scan_files(root)):
        rel = p.resolve().relative_to(root.resolve()).as_posix() \
            if p.resolve().is_relative_to(root.resolve()) else p.as_posix()
        try:
            findings.extend(lint_source(
                p.read_text(errors="replace"), rel, corpus))
        except SyntaxError as e:
            findings.append(Finding(
                "LINT000", rel, int(e.lineno or 0),
                f"file does not parse: {e.msg}"))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

BASELINE_NAME = "lint_baseline.json"


def baseline_path(root: Optional[Path] = None) -> Path:
    return (Path(root) if root is not None else repo_root()) \
        / "anomod_torch" / "analysis" / BASELINE_NAME


def load_baseline(path) -> List[str]:
    p = Path(path)
    if not p.is_file():
        return []
    doc = json.loads(p.read_text())
    keys = doc.get("findings", [])
    if not isinstance(keys, list) or \
            not all(isinstance(k, str) for k in keys):
        raise ValueError(f"malformed lint baseline: {p}")
    return keys


def save_baseline(path, keys: Iterable[str]) -> None:
    """Write a baseline.  LINT000 keys are dropped: a malformed or
    reasonless suppression can only be fixed, never ridden."""
    Path(path).write_text(json.dumps(
        {"version": 1,
         "findings": sorted({k for k in keys
                             if not k.startswith("LINT000|")})},
        indent=2) + "\n")


def summarize(findings: List[Finding],
              baseline: Iterable[str] = ()) -> dict:
    """The gate verdict: new findings fail; baselined ones ride (and
    only shrink); suppressed ones are counted, not failed."""
    base = set(baseline)
    active = [f for f in findings if not f.suppressed]
    # LINT000 (reasonless/malformed suppression) is never baselinable:
    # a baseline entry for it would let `--update-baseline` launder the
    # exact silent-disable hole the rule exists to close
    new = [f for f in active
           if f.key not in base or f.rule == "LINT000"]
    known = [f for f in active
             if f.key in base and f.rule != "LINT000"]
    stale = sorted(base - {f.key for f in active})
    return {
        "check": "anomod_lint",
        "rules": len(RULES),
        "findings": len(new),
        "baselined": len(known),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "baseline_size": len(base),
        "stale_baseline": stale,
        "status": "ok" if not new else "contract-violations",
        "new": [f.render() for f in new],
    }


def run_gate(root: Optional[Path] = None, include_parity: bool = True,
             baseline_file=None) -> Tuple[dict, List[Finding]]:
    """THE gate composition — lint + parity audit + baseline compare —
    in one place, shared by ``python -m anomod_torch lint`` (cli.py),
    the gate (``python -m anomod_torch.analysis.contracts``) and the
    ``validate`` status
    block, so the three surfaces can never report different verdicts
    for the same tree.  Returns ``(summary_doc, findings)``."""
    root = Path(root) if root is not None else repo_root()
    findings = lint_repo(root)
    if include_parity:
        from anomod_torch.analysis.parity import run_parity_audit
        findings = findings + run_parity_audit(root)
    bpath = baseline_file if baseline_file is not None \
        else baseline_path(root)
    return summarize(findings, load_baseline(bpath)), findings


def status_block(root: Optional[Path] = None) -> dict:
    """The ``validate`` contract-health block: rule inventory,
    live finding counts and baseline size, plus the parity-surface
    verdict — contract health next to the native/cache blocks."""
    doc, _ = run_gate(root)
    return {"rules": doc["rules"], "findings": doc["findings"],
            "baselined": doc["baselined"],
            "suppressed": doc["suppressed"],
            "baseline_size": doc["baseline_size"],
            "status": doc["status"]}


# ---------------------------------------------------------------------------
# the rule catalog (ONE place; docs/CONTRACTS.md and `lint --rules`
# render it; the text is the JAX package's, word for word)
# ---------------------------------------------------------------------------

RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("LINT000", "lint",
         "malformed or reasonless suppression directive",
         "a silent disable is the vigilance hole this plane replaces"),
    Rule("D101", "determinism",
         "wall-clock/stall call (time.time, monotonic, sleep, "
         "datetime.now) in a canonical-plane module",
         "the flight journal and audit replay (PR 9) require every "
         "canonical decision to be a function of seed+config alone"),
    Rule("D102", "determinism",
         "time.perf_counter outside wall-leg form (t-var assign or "
         "`... - t0` delta feeding a variant wall field)",
         "wall legs are the declared variant tier (PR 7's five-leg "
         "decomposition); any other clock use can leak into decisions"),
    Rule("D103", "determinism",
         "unseeded or global-state RNG (np.random.default_rng(), "
         "legacy np.random.*, stdlib random.*) in a canonical module",
         "PR 6 pinned RCA verdicts byte-identical across shard counts "
         "only because every sampler is keyed by (seed, tenant, window)"),
    Rule("D104", "determinism",
         "id() call in a canonical module (memory-address keys differ "
         "across processes and replays)",
         "an id()-keyed dict iterates in address order — the same "
         "failure shape as the PR-5 torn-scrape bug: invisible locally"),
    Rule("D105", "determinism",
         "set iteration feeding ordered output (for/list/tuple/"
         "enumerate/join over a set) without sorted()",
         "set order varies across processes; the shard partition and "
         "every journal digest assume stable iteration order"),
    Rule("E201", "env-contract",
         "ANOMOD_* env read that is neither Config-validated "
         "(anomod/config.py) nor documented (README/docs)",
         "PR 3's check_env_contract found 10 rotted knobs; this is its "
         "AST-level upgrade (catches aliased reads)"),
    Rule("E202", "env-contract",
         "dynamic ANOMOD_* env read (f-string/concat key) — "
         "statically unresolvable, must route through anomod.config",
         "the grep gate could not see os.environ[f'ANOMOD_{name}'] — "
         "a documented false negative of the PR-3 scanner"),
    Rule("S301", "seam",
         "pool-plane internals (._slot/._slots/._runner) touched "
         "outside the seam modules (replay.py, serve/batcher.py)",
         "PR 8's pool.put(None, ...) broadcast corruption: every "
         "bypass of the get_state/set_state/gather seam is one bug "
         "away from fleet-wide state corruption"),
    Rule("S302", "seam",
         "gather-side return aliasing a pool plane row (subscript on "
         "agg/hist without .copy()/np.asarray)",
         "the gather contract is ALWAYS-COPY (PR 8): an aliased row "
         "mutates under the next scatter fold — the PR-4 scratch-"
         "aliasing bug's state-pool twin"),
    Rule("P401", "parity",
         "ServeReport field neither in SHARD_VARIANT_REPORT_FIELDS "
         "nor named by any test",
         "a new report field silently widening the variant surface "
         "is how the N-shard==1-shard pin rots"),
    Rule("P402", "parity",
         "stale SHARD_VARIANT_REPORT_FIELDS entry (names no "
         "ServeReport field)",
         "a stale exclusion hides the day a real field takes the name"),
    Rule("P403", "parity",
         "flight tick-record key outside the declared contract "
         "(PLANES + FLIGHT_VARIANT_KEYS + the tick spine)",
         "an undeclared key is invisible to audit diff — decisions "
         "could diverge without the bisector ever naming them"),
    Rule("P404", "parity",
         "declared flight plane/variant key missing from the tick "
         "record",
         "every record carries every tier (the self-describing-shape "
         "contract the variant-key tests pin)"),
    Rule("C601", "commit-barrier",
         "read of deferred-commit state (tenant detectors/replays, "
         "RCA queue, report/flight/perf/census/policy publishers) "
         "between a deferred dispatch and _commit_deferred()",
         "the async serve tick (ANOMOD_SERVE_ASYNC_COMMIT) keeps byte "
         "parity only because nothing reads scored state while folds "
         "are in flight — one read in the window is a silent parity "
         "break the journal diff would catch hours later"),
    Rule("L501", "lock",
         "shared-state mutation outside `with self._lock` in a "
         "lock-owning class (Registry/Histogram/Tracer)",
         "PR 5's torn histogram scrape: 105 corrupt scrapes in the "
         "GIL-churn hammer before samples() took one locked snapshot"),
]}
