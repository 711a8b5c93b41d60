"""A small YAML writer and reader for the port's rendered documents, so
the port needs no PyYAML (the JAX package renders with
``yaml.safe_dump(..., sort_keys=False)`` / ``safe_dump_all``).

:func:`dump` / :func:`dump_all` give the bytes PyYAML's safe dumper gives
(default width 80, indent 2, no unicode) on the subset these documents
use: block mappings with string keys in insertion order, block sequences
(indentless under a mapping key), ``{}`` / ``[]`` for empty containers,
``true`` / ``false`` / ``null`` / decimal ints, plain strings, and
single-quoted strings where a plain one would read as another type or
start with an indicator (every CRD's ``value: '100'``, the blade argv's
``- '300'``).  Anything outside the subset raises ``ValueError`` rather
than guess at PyYAML's rules: a float, a non-string key, a key PyYAML
would write as a complex ``? key``, a string with a character outside
printable ASCII (a line break, a tab, non-ASCII), a string PyYAML would
fold at the width, a top-level scalar.

:func:`load` reads one document of the same subset back (the CRDs
``chaos.parse_mesh_crd_yaml`` reads) and raises ``ValueError`` on
anything else: flow collections other than ``{}`` / ``[]``, double
quotes, comments, anchors, tags, block scalars, other scalar types.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

#: PyYAML's implicit resolvers (``yaml/resolver.py``), each with the
#: first characters it is tried on: a string one of them matches is not
#: read back as a string, so it is single-quoted
_RESOLVERS: Tuple[Tuple[str, "re.Pattern", str], ...] = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?: ~ |null|Null|NULL | )$", re.X), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                            re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
    ("yaml", re.compile(r"^(?:!|&|\*)$"), "!&*"),
)

_WIDTH = 80          # PyYAML's best_width
_KEY_MAX = 100       # well inside PyYAML's simple-key limit (128 less a tag)
_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_DEC_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")


def _resolves(text: str) -> str:
    """The implicit type PyYAML gives a plain ``text`` ("str" for none)."""
    if text == "":
        return "null"
    for kind, rx, first in _RESOLVERS:
        if text[0] in first and rx.match(text):
            return kind
    return "str"


def _plain_ok(text: str) -> bool:
    """PyYAML's ``allow_block_plain`` (``Emitter.analyze_scalar``) for a
    single-line printable-ASCII ``text``."""
    if text.startswith(("---", "...")) or text[0] == " " or text[-1] == " ":
        return False
    n = len(text)
    for i, ch in enumerate(text):
        followed = i + 1 >= n or text[i + 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                return False
            if ch in "?:-" and followed:
                return False
        elif ch == ":" and followed:
            return False
        elif ch == "#" and text[i - 1] == " ":
            return False
    return True


def _scalar(value: Any, column: int, key: bool = False) -> str:
    """One scalar as PyYAML writes it, its first character at
    ``column``."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "null"
    if isinstance(value, int):
        return str(value)
    if not isinstance(value, str):
        raise ValueError(f"yamlsafe: no {type(value).__name__} scalars")
    if any(not (" " <= ch <= "~") for ch in value):
        raise ValueError(f"yamlsafe: not printable ASCII: {value!r}")
    if key and not 0 < len(value) <= _KEY_MAX:
        raise ValueError(f"yamlsafe: not a simple key: {value!r}")
    if value and _resolves(value) == "str" and _plain_ok(value):
        out = value
    else:
        out = "'" + value.replace("'", "''") + "'"
    if not key and " " in value and column + len(out) > _WIDTH:
        raise ValueError(f"yamlsafe: PyYAML would fold {value!r}")
    return out


def _empty(value: Any) -> str:
    """``{}`` / ``[]`` for an empty container, else ""."""
    if isinstance(value, dict) and not value:
        return "{}"
    if isinstance(value, list) and not value:
        return "[]"
    return ""


def _mapping(doc: dict, indent: int, lines: List[str], head: str) -> None:
    """A non-empty block mapping at ``indent``; its first key goes after
    ``head`` (a sequence item's ``- ``), the rest on lines of their own."""
    for i, (k, v) in enumerate(doc.items()):
        if not isinstance(k, str):
            raise ValueError(f"yamlsafe: key {k!r} is not a string")
        lead = head if i == 0 else " " * indent
        line = lead + _scalar(k, len(lead), key=True) + ":"
        flat = _empty(v)
        if flat:
            lines.append(f"{line} {flat}")
        elif isinstance(v, dict):
            lines.append(line)
            _mapping(v, indent + 2, lines, " " * (indent + 2))
        elif isinstance(v, list):
            lines.append(line)
            _sequence(v, indent, lines, " " * indent)
        else:
            lines.append(f"{line} {_scalar(v, len(line) + 1)}")


def _sequence(doc: list, indent: int, lines: List[str], head: str) -> None:
    for i, v in enumerate(doc):
        lead = (head if i == 0 else " " * indent) + "- "
        flat = _empty(v)
        if flat:
            lines.append(lead + flat)
        elif isinstance(v, dict):
            _mapping(v, indent + 2, lines, lead)
        elif isinstance(v, list):
            _sequence(v, indent + 2, lines, lead)
        else:
            lines.append(lead + _scalar(v, len(lead)))


def _no_aliases(doc: Any, seen: set) -> None:
    """PyYAML writes a container that appears twice as an anchor and an
    alias: outside the subset."""
    if isinstance(doc, (dict, list)):
        if id(doc) in seen:
            raise ValueError("yamlsafe: a container appears twice")
        seen.add(id(doc))
        for v in doc.values() if isinstance(doc, dict) else doc:
            _no_aliases(v, seen)


def _document(doc: Any, first: bool) -> str:
    _no_aliases(doc, set())
    flat = _empty(doc)
    if flat:
        return (flat if first else "--- " + flat) + "\n"
    lines: List[str] = [] if first else ["---"]
    if isinstance(doc, dict):
        _mapping(doc, 0, lines, "")
    elif isinstance(doc, list):
        _sequence(doc, 0, lines, "")
    else:
        raise ValueError("yamlsafe: a document is a mapping or a sequence")
    return "\n".join(lines) + "\n"


def dump(doc: Any) -> str:
    """``yaml.safe_dump(doc, sort_keys=False)`` on the subset."""
    return _document(doc, True)


def dump_all(docs) -> str:
    """``yaml.safe_dump_all(docs, sort_keys=False)`` on the subset."""
    return "".join(_document(d, i == 0) for i, d in enumerate(docs))


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------

def _read_scalar(text: str) -> Any:
    if text in ("{}", "[]"):
        return {} if text == "{}" else []
    if len(text) >= 2 and text[0] == "'" and text[-1] == "'":
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"yamlsafe: bad single-quoted scalar {text!r}")
        return body.replace("''", "'")
    if not text or not _plain_ok(text):
        raise ValueError(f"yamlsafe: not a plain scalar: {text!r}")
    kind = _resolves(text)
    if kind == "str":
        return text
    if kind == "bool":
        return text in _BOOL_TRUE
    if kind == "null":
        return None
    if kind == "int" and _DEC_INT.match(text):
        return int(text)
    raise ValueError(f"yamlsafe: unsupported {kind} scalar {text!r}")


def _split_key(body: str) -> Tuple[str, str]:
    """``key: rest`` or ``key:`` → (key, rest); a quoted key may hold
    ``: ``."""
    if body.startswith("'"):
        end = 1
        while True:
            end = body.find("'", end)
            if end < 0:
                raise ValueError(f"yamlsafe: unterminated key in {body!r}")
            if body[end + 1:end + 2] == "'":
                end += 2
                continue
            break
        key, rest = body[:end + 1], body[end + 1:]
        if not rest.startswith(":"):
            raise ValueError(f"yamlsafe: no mapping key in {body!r}")
        return key, rest[1:]
    m = re.search(r":(?: |$)", body)
    if m is None:
        raise ValueError(f"yamlsafe: no mapping key in {body!r}")
    return body[:m.start()], body[m.start() + 1:]


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.split("\n"):
            if not raw.strip():
                continue
            if raw.lstrip().startswith("#") or "\t" in raw:
                raise ValueError(f"yamlsafe: unsupported line {raw!r}")
            if raw.startswith(("---", "...")):
                raise ValueError("yamlsafe: one document, no markers")
            body = raw.lstrip(" ")
            self.lines.append((len(raw) - len(body), body.rstrip(" ")))
        self.pos = 0

    def node(self, indent: int) -> Any:
        col, body = self.lines[self.pos]
        if col != indent:
            raise ValueError(f"yamlsafe: bad indent at {body!r}")
        if body.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def value(self, rest: str, indent: int) -> Any:
        """What follows ``key:`` of a mapping at ``indent``: a scalar on
        its line, a block below it, or an indentless sequence."""
        rest = rest.strip(" ")
        if rest:
            return _read_scalar(rest)
        if self.pos >= len(self.lines):
            raise ValueError("yamlsafe: a key with no value")
        col, body = self.lines[self.pos]
        if col > indent:
            return self.node(col)
        if col == indent and body.startswith("- "):
            return self.sequence(indent)
        raise ValueError(f"yamlsafe: a key with no value before {body!r}")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            col, body = self.lines[self.pos]
            if col < indent or col == indent and body.startswith("- "):
                break
            if col > indent:
                raise ValueError(f"yamlsafe: bad indent at {body!r}")
            self.pos += 1
            k, rest = _split_key(body)
            key = _read_scalar(k)
            if not isinstance(key, str) or key in out:
                raise ValueError(f"yamlsafe: bad or repeated key {k!r}")
            out[key] = self.value(rest, indent)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.pos < len(self.lines):
            col, body = self.lines[self.pos]
            if col != indent or not body.startswith("- "):
                if col > indent:
                    raise ValueError(f"yamlsafe: bad indent at {body!r}")
                break
            item = body[2:]
            if not item or item[0] == " ":
                raise ValueError(f"yamlsafe: bad sequence item {body!r}")
            if not item.startswith("- ") and _scalar_item(item):
                self.pos += 1
                out.append(_read_scalar(item))
            else:   # a nested sequence or mapping opens on the item's line
                self.lines[self.pos] = (indent + 2, item)
                out.append(self.node(indent + 2))
        return out


def _scalar_item(item: str) -> bool:
    """Whether a sequence item is one scalar (not a mapping's first
    key)."""
    if item in ("{}", "[]"):
        return True
    if item[0] == "'":
        body = item[1:-1]
        return len(item) >= 2 and item.endswith("'") \
            and "'" not in body.replace("''", "")
    return re.search(r":(?: |$)", item) is None


def load(text: str) -> Any:
    """One document of the subset back into dicts, lists and scalars."""
    reader = _Reader(text)
    if not reader.lines:
        raise ValueError("yamlsafe: an empty document")
    col, body = reader.lines[0]
    if len(reader.lines) == 1 and body in ("{}", "[]"):
        return _read_scalar(body)
    doc = reader.node(col)
    if reader.pos != len(reader.lines):
        raise ValueError(
            f"yamlsafe: trailing content at {reader.lines[reader.pos][1]!r}")
    return doc
