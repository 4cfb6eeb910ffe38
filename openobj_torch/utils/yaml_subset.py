"""A YAML reader and writer for the subset the port's files use, without
PyYAML.

``load`` reads block mappings and block sequences (a sequence may sit at its
key's indentation, and an item may open a mapping on its own line, as in
``- name: wall``), flow sequences and mappings of scalars (``[0.1, 0.2]``,
``{0: 0, 1: 1}``), plain, single- and double-quoted scalars typed as
``yaml.safe_load`` types them, ``#`` comments and ``---`` / ``...``
markers. It covers the association YAML (maskclustering/config/room_0.yaml),
the class colour maps (``mapping`` / ``mapped_class`` / ``mapped_colors``,
``viz.class_tables.write_yaml``'s layout) and Replica's render_config.yaml
(``classes:`` as a list of mappings with ``name``). Anything else (anchors,
tags, block scalars, scalars over several lines, tabs as indentation) raises
``ValueError``.

``parse_flat`` is ``load`` held to a flat mapping of scalars and lists of
scalars; ``dump_flat`` writes such a mapping as ``yaml.safe_dump`` does.
"""

from __future__ import annotations

import math
import re

# PyYAML's implicit scalar types (yaml.resolver.Resolver, YAML 1.1), but for
# the sexagesimal forms, which none of these files use
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"),
                         True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_SPECIAL = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
            "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
            "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
            ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
# a block mapping's plain key, a colon, then its value if any
_KEY = re.compile(r"([^\s:#'\"\[\]{},&*!|>%@`-][^:#'\"\[\]{}]*?)\s*:(?:\s+(.*))?")
# what a plain value may not start with: indicators of what is not supported
_NOT_PLAIN = tuple("&*!|>%@`")


def scalar(text: str):
    """One plain or quoted YAML scalar, typed as ``yaml.safe_load`` types it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return bytes(t[1:-1], "utf-8").decode("unicode_escape")
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if t in _SPECIAL:
        return _SPECIAL[t]
    if _INT.fullmatch(t):
        v = t.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(t):
        return float(t.replace("_", ""))
    return t


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at its start or after a blank,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _skip_blanks(t: str, i: int) -> int:
    while i < len(t) and t[i] == " ":
        i += 1
    return i


def _flow_scalar(t: str, i: int, stops: str, where: str):
    """The quoted or plain scalar at ``t[i]`` (a plain one ends at a
    character of ``stops``) and the index after it."""
    j = i
    if j < len(t) and t[j] in "'\"":
        q = t[j]
        j += 1
        while True:
            if j >= len(t):
                raise ValueError(f"{where}: unterminated quoted scalar")
            if q == "'" and t[j:j + 2] == "''":
                j += 2
            elif t[j] == q:
                return scalar(t[i:j + 1]), j + 1
            else:
                j += 1
    while j < len(t) and t[j] not in stops:
        if t[j] in "[{":
            raise ValueError(f"{where}: unsupported flow scalar")
        j += 1
    return scalar(t[i:j]), j


def _flow(t: str, i: int, where: str):
    """The flow node at ``t[i]`` (``[...]``, ``{...}`` or a scalar) and the
    index after it."""
    i = _skip_blanks(t, i)
    if i >= len(t) or t[i] not in "[{":
        return _flow_scalar(t, i, ",]}", where)
    close = "]" if t[i] == "[" else "}"
    out = [] if close == "]" else {}
    i += 1
    while True:
        i = _skip_blanks(t, i)
        if i >= len(t):
            raise ValueError(f"{where}: unterminated flow collection")
        if t[i] == close:
            return out, i + 1
        if close == "]":
            v, i = _flow(t, i, where)
            out.append(v)
        else:
            key, i = _flow_scalar(t, i, ":,}", where)
            if t[i:i + 1] != ":" or t[i + 1:i + 2] not in (" ", ",", "}", ""):
                raise ValueError(f"{where}: a flow mapping entry without ': '")
            out[key], i = _flow(t, i + 1, where)
        i = _skip_blanks(t, i)
        if t[i:i + 1] == ",":
            i += 1
        elif t[i:i + 1] != close:
            raise ValueError(f"{where}: expected ',' or {close!r} in a flow collection")


def _value(text: str, where: str):
    """The value of a ``key: value`` line or a ``- value`` item."""
    t = text.strip()
    if t[0] in "[{":
        v, i = _flow(t, 0, where)
        if i != len(t):
            raise ValueError(f"{where}: text after a flow collection")
        return v
    if t.startswith(_NOT_PLAIN):
        raise ValueError(f"{where}: unsupported YAML value")
    if t[0] in "'\"":
        v, i = _flow_scalar(t, 0, "", where)
        if i != len(t):
            raise ValueError(f"{where}: text after a quoted scalar")
        return v
    if ": " in t or t.endswith(":") or t == "-" or t.startswith("- "):
        raise ValueError(f"{where}: a mapping or sequence where a scalar belongs")
    return scalar(t)


def _is_item(s: str) -> bool:
    return s == "-" or s.startswith("- ")


def _node(lines: list, i: int, indent: int):
    """The block node whose first line is ``lines[i]``, at ``indent``, and
    the index of the line after it."""
    n, _, s = lines[i]
    if _is_item(s):
        return _sequence(lines, i, indent)
    if _KEY.fullmatch(s):
        return _mapping(lines, i, indent)
    return _value(s, f"line {n}"), i + 1


def _sequence(lines: list, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][1] == indent and _is_item(lines[i][2]):
        n, _, s = lines[i]
        rest = s[1:].lstrip(" ")
        if not rest:
            if i + 1 < len(lines) and lines[i + 1][1] > indent:
                v, i = _node(lines, i + 1, lines[i + 1][1])
            else:
                v, i = None, i + 1
        elif _is_item(rest) or _KEY.fullmatch(rest):
            # a compact node: its first line starts after "- "
            col = indent + len(s) - len(rest)
            lines[i] = (n, col, rest)
            v, i = _node(lines, i, col)
        else:
            v, i = _value(rest, f"line {n}"), i + 1
        out.append(v)
    return out, i


def _mapping(lines: list, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, s = lines[i]
        m = _KEY.fullmatch(s)
        if m is None:
            raise ValueError(f"line {n}: not a 'key: value' line: {s!r}")
        key, value = scalar(m.group(1)), (m.group(2) or "").strip()
        i += 1
        if value:
            out[key] = _value(value, f"line {n}")
        elif i < len(lines) and (lines[i][1] > indent
                                 or (lines[i][1] == indent and _is_item(lines[i][2]))):
            out[key], i = _node(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def load(text: str):
    """YAML text of the subset above -> its value, as ``yaml.safe_load``
    reads it (None for an empty document)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        s = line.lstrip(" ")
        if not s or (line in ("---", "...")):
            continue
        if s[0] == "\t":
            raise ValueError(f"line {n}: a tab in the indentation")
        if s.startswith(("%", "--- ")):
            raise ValueError(f"line {n}: unsupported YAML directive or marker: {raw!r}")
        lines.append((n, len(line) - len(s), s))
    if not lines:
        return None
    value, i = _node(lines, 0, lines[0][1])
    if i != len(lines):
        raise ValueError(f"line {lines[i][0]}: unexpected indentation or content")
    return value


def parse_flat(text: str) -> dict:
    """``load`` held to a flat mapping of scalars and lists of scalars (the
    association YAML's schema); anything else raises ``ValueError``."""
    out = load(text)
    if out is None:
        return {}
    if not isinstance(out, dict):
        raise ValueError("the YAML document is not a mapping")
    for k, v in out.items():
        if isinstance(v, dict) or (isinstance(v, list)
                                   and any(isinstance(x, (dict, list)) for x in v)):
            raise ValueError(f"key {k!r}: nested YAML is not supported")
    return out


def _plain_ok(s: str) -> bool:
    """Whether ``s`` may be written unquoted and read back as itself."""
    return (bool(re.fullmatch(r"[A-Za-z_/][A-Za-z0-9_ ./'-]*", s)) and s == s.strip()
            and scalar(s) == s)


def _dump_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        # PyYAML's float representer: an exponent without a dot gains one
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        return v if _plain_ok(v) else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a YAML scalar")


def dump_flat(cfg: dict) -> str:
    """A flat dict of scalars and lists of scalars -> YAML text, keys
    sorted and sequences in block style, as ``yaml.safe_dump`` writes it;
    ``parse_flat`` and ``yaml.safe_load`` read it back to ``cfg``."""
    lines = []
    for k in sorted(cfg):
        if not _plain_ok(k):
            raise ValueError(f"YAML key {k!r} is not a plain word")
        v = cfg[k]
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:" if v else f"{k}: []")
            lines += [f"- {_dump_scalar(x)}" for x in v]
        else:
            lines.append(f"{k}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
