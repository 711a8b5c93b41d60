"""Contract-checking static analysis plane of the port.

Counterpart of ``anomod/analysis/`` (the same exports, rule ids, rule
catalog, directive grammar and baseline semantics), held to it by
``tests/test_torch_contracts.py``.  It lints the port's own tree: the
serve plane's guarantees (byte-identical N-shard and 1-shard states,
``audit replay`` reproducing a run from its header, no-score-gap
recovery) rest on the same conventions in ``anomod_torch/`` as in
``anomod/``, and the same AST rules mechanize them:

- ``D1xx`` determinism: canonical-plane modules (``anomod_torch/serve/``,
  ``anomod_torch/replay.py``, ``anomod_torch/obs/flight.py``) must not
  read the wall clock outside wall-leg timing form, call unseeded RNG,
  key on ``id()``, or feed set iteration into ordered output.
- ``E2xx`` env contract: every ``ANOMOD_*`` env read must be in
  ``anomod_torch/config.py`` or documented (``README.md``,
  ``docs/*.md``); dynamic reads are refused.
- ``S3xx`` seam discipline: pool-plane internals (``_slot`` /
  ``_slots`` / ``_runner``) stay inside ``anomod_torch/replay.py`` and
  ``anomod_torch/serve/batcher.py``; gather-side returns never alias
  pool rows.
- ``P4xx`` parity surface: every ``ServeReport`` field is on the
  engine's ``VARIANT_REPORT_FIELDS`` or named by a test; the flight tick
  record carries exactly its declared keys.
- ``L5xx`` lock discipline and ``C6xx`` the deferred-commit barrier.

Suppression syntax (reason REQUIRED)::

    x = time.time()   # anomod-lint: disable=D101 — forensic timestamp

Run it with ``python -m anomod_torch lint`` or the gate
``python -m anomod_torch.analysis.contracts`` (``--env``: the env
contract alone).  Pure stdlib ``ast`` and text: it never initializes
CUDA, probes the card or runs the code it reads.
"""

from anomod_torch.analysis.lint import (Finding, RULES, lint_repo,
                                        lint_source, load_baseline,
                                        repo_root, status_block)
from anomod_torch.analysis.parity import run_parity_audit

__all__ = ["Finding", "RULES", "lint_repo", "lint_source",
           "load_baseline", "repo_root", "run_parity_audit",
           "status_block"]
