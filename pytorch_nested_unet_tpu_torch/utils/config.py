"""Config helpers (counterpart of utils/config.py): `str2bool` (reference
utils.py:4-10) and the `config.yml` capsule, read and written without a YAML
package.

The capsule is a flat mapping of null, bools, ints, floats, strings and flat
lists of those. `save_config` writes it with keys sorted, as `yaml.dump`
does, in a form PyYAML's `safe_load` reads back to the same values: floats
always carry a `.` before their exponent (`1.0e-05`; PyYAML reads `1e-05` as
a string) and are `.inf` / `.nan` when not finite; a string PyYAML would read
as anything else (`'1,2'`, `'yes'`, `'0.5'`, `''`, `'null'`, JSON) is quoted.
`load_config` reads what `save_config` writes and what the JAX package's
`yaml.dump` writes for the same mapping (block lists, quoted and folded
scalars), resolving plain scalars by YAML 1.1's rules as PyYAML does.
"""

import argparse
import math
import os
import re

_BOOL_WORDS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_NULL_WORDS = ("~", "null", "Null", "NULL", "")
# PyYAML's implicit resolvers (yaml/resolver.py), without sexagesimal numbers
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# a string written without quotes: starts with a letter or '_' or '/', holds
# only path-like characters, and resolves to no other type
_PLAIN_RE = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./-]*$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _resolve(s: str):
    """A plain scalar's value under PyYAML's implicit resolvers."""
    if s in _NULL_WORDS:
        return None
    if _BOOL_RE.match(s):
        return _BOOL_WORDS[s.lower()]
    if _INT_RE.match(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT_RE.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t == ".nan":
            return math.nan
        return float(t)
    return s


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)  # PyYAML's own float representer
        return r
    if isinstance(v, str):
        if _PLAIN_RE.match(v) and isinstance(_resolve(v), str):
            return v
        if all(" " <= ch <= "~" for ch in v):
            return "'" + v.replace("'", "''") + "'"
        out = []
        for ch in v:
            if ch in '"\\':
                out.append("\\" + ch)
            elif " " <= ch <= "~":
                out.append(ch)
            else:
                out.append(f"\\U{ord(ch):08x}")
        return '"' + "".join(out) + '"'
    raise TypeError(f"config.yml holds null, bools, ints, floats, strings and flat "
                    f"lists of them, not {type(v).__name__} ({v!r})")


def dump_config(config: dict) -> str:
    """The config.yml text of a flat mapping (keys sorted, as yaml.dump)."""
    lines = []
    for key in sorted(config):
        value = config[key]
        if isinstance(value, (list, tuple)):
            if not value:
                lines.append(f"{_dump_scalar(str(key))}: []")
                continue
            lines.append(f"{_dump_scalar(str(key))}:")
            lines += [f"- {_dump_scalar(item)}" for item in value]
        else:
            lines.append(f"{_dump_scalar(str(key))}: {_dump_scalar(value)}")
    return "\n".join(lines) + "\n" if lines else "{}\n"


def _fold(parts):
    """Join a multi-line scalar's lines: a line break between two non-empty
    lines is one space, each empty line a newline."""
    out, pending = "", 0
    for i, part in enumerate(parts):
        if part == "":
            pending += 1
            continue
        if i and out:
            out += "\n" * pending if pending else " "
        elif pending:
            out += "\n" * pending
        out += part
        pending = 0
    return out


def _unescape(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        nxt = body[i + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(nxt)
        if width:
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            out.append(_ESCAPES[nxt])
            i += 2
    return "".join(out)


def _parse_scalar(text: str):
    """A scalar's text (continuation lines already joined by '\\n') -> value."""
    parts = [p.strip() for p in text.split("\n")]
    head = parts[0]
    if head.startswith("'"):
        body = _fold(parts)
        if not body.endswith("'") or len(body) < 2:
            raise ValueError(f"config.yml: unterminated quoted scalar {text!r}")
        return body[1:-1].replace("''", "'")
    if head.startswith('"'):
        # folded as above, except that a line ending in '\\' joins the next
        # without a space
        joined, pending = head, 0
        for part in parts[1:]:
            if part == "":
                pending += 1
            elif joined.endswith("\\") and not pending:
                joined = joined[:-1] + part
            else:
                joined += ("\n" * pending if pending else " ") + part
                pending = 0
        if not joined.endswith('"') or len(joined) < 2:
            raise ValueError(f"config.yml: unterminated quoted scalar {text!r}")
        return _unescape(joined[1:-1])
    if head == "[]":
        return []
    return _resolve(_fold(parts))


def parse_config(text: str) -> dict:
    """Read config.yml text: a flat mapping whose values are scalars or
    block lists (`- item` lines, `[]` when empty) of scalars."""
    entries = []  # [key, [value lines], [list items]]
    for raw in text.splitlines():
        if raw.lstrip().startswith("#") or raw.strip() in ("---", "{}"):
            continue
        if not raw.strip():  # an empty line inside a folded scalar is a newline
            if entries:
                (entries[-1][2][-1] if entries[-1][2] else entries[-1][1]).append("")
            continue
        if raw.startswith("- "):
            if not entries or entries[-1][1] != [""]:
                raise ValueError(f"config.yml: list item outside a list: {raw!r}")
            entries[-1][2].append([raw[2:]])
        elif raw[0] in " \t":
            if not entries:
                raise ValueError(f"config.yml: continuation before any key: {raw!r}")
            target = entries[-1][2][-1] if entries[-1][2] else entries[-1][1]
            target.append(raw)
        else:
            key, sep, value = raw.partition(": ") if ": " in raw else raw.partition(":")
            if not sep:
                raise ValueError(f"config.yml: expected 'key: value', got {raw!r}")
            entries.append([key, [value.strip()], []])
    config = {}
    for key, value, items in entries:
        key = _parse_scalar(key)
        if items:
            config[key] = [_parse_scalar("\n".join(item)) for item in items]
        else:
            config[key] = _parse_scalar("\n".join(value))
    return config


def save_config(config: dict, model_dir: str):
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.yml"), "w") as f:
        f.write(dump_config(config))


def load_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.yml")) as f:
        return parse_config(f.read())
