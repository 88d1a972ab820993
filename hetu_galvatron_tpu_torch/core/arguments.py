"""YAML config loading with dotted overrides.

Counterpart of ``hetu_galvatron_tpu/core/arguments.py`` without PyYAML: a
small reader for the YAML subset the repo's configs use (nested block
mappings, block and flow lists, flow mappings, plain and quoted scalars,
comments) with PyYAML's YAML 1.1 scalar rules, the ``include:`` key, and the
same ``key=value`` / ``++key=value`` override grammar (including the
``1e-4`` handling YAML 1.1 misses).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


class YamlSubsetError(ValueError):
    pass


def _plain_scalar(text: str) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return text


def _unquote(text: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    return bytes(text[1:-1], "utf-8").decode("unicode_escape")


def _split_flow(body: str) -> List[str]:
    """Split a flow collection's body on top-level commas."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
            continue
        cur.append(ch)
    tail = "".join(cur).strip()
    if tail:  # a trailing comma adds no entry
        parts.append(tail)
    return parts


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """'key: rest' -> (key, rest); None when the text is not a mapping
    entry (no ': ' / trailing ':' outside quotes and flow brackets)."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text)
                                           or text[i + 1] == " "):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def parse_value(text: str) -> Any:
    """One inline YAML value: quoted or plain scalar, flow list or map."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "'\"":
        if len(text) < 2 or text[-1] != text[0]:
            raise YamlSubsetError(f"unterminated quoted scalar: {text}")
        return _unquote(text)
    if text[0] == "[":
        if text[-1] != "]":
            raise YamlSubsetError(f"unterminated flow list: {text}")
        return [parse_value(p) for p in _split_flow(text[1:-1])]
    if text[0] == "{":
        if text[-1] != "}":
            raise YamlSubsetError(f"unterminated flow mapping: {text}")
        out = {}
        for part in _split_flow(text[1:-1]):
            kv = _split_key(part)
            if kv is None:
                raise YamlSubsetError(f"flow mapping entry without ':': "
                                      f"{part}")
            out[parse_value(kv[0])] = parse_value(kv[1])
        return out
    if text[0] in "&*!|>%@`":
        raise YamlSubsetError(f"YAML feature outside the supported subset: "
                              f"{text}")
    return _plain_scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlSubsetError("tabs in indentation")
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _parse_block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out_list = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest:
                out_list.append(parse_value(rest))
            elif i < len(lines) and lines[i][0] > indent:
                val, i = _parse_block(lines, i, lines[i][0])
                out_list.append(val)
            else:
                out_list.append(None)
        return out_list, i
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise YamlSubsetError(f"expected 'key: value', got "
                                  f"{lines[i][1]!r}")
        key, rest = parse_value(kv[0]), kv[1]
        i += 1
        if rest:
            out[key] = parse_value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def safe_load(text: str) -> Any:
    """The YAML subset reader (returns what ``yaml.safe_load`` returns for
    documents inside the subset, and raises outside it)."""
    lines = _lines(text)
    if not lines:
        return None
    first = lines[0][1]
    if len(lines) == 1 and _split_key(first) is None \
            and not (first.startswith("- ") or first == "-"):
        return parse_value(first)
    val, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"bad indentation at {lines[i][1]!r}")
    return val


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        raw = safe_load(f.read()) or {}
    includes = raw.pop("include", None)
    if includes:
        if isinstance(includes, str):
            includes = [includes]
        merged: Dict[str, Any] = {}
        for inc in includes:
            inc_path = inc if os.path.isabs(inc) else os.path.join(
                os.path.dirname(os.path.abspath(path)), inc)
            merged = _deep_merge(merged, _load_yaml(inc_path))
        raw = _deep_merge(merged, raw)
    return raw


def _parse_scalar(text: str) -> Any:
    """Parse one override value ('8'->int, 'true'->bool, 'a,b'->str)."""
    try:
        val = safe_load(text)
    except YamlSubsetError:
        return text
    if isinstance(val, str):
        # YAML 1.1 misses bare scientific notation like '1e-4'
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
    return val


def _apply_override(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"override {dotted}: {k} is not a mapping")
    node[keys[-1]] = value


def parse_overrides(overrides: Sequence[str]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for item in overrides:
        item = item.strip()
        if not item:
            continue
        item = item.lstrip("+")  # accept hydra-style '++key=value'
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        key, _, val = item.partition("=")
        _apply_override(tree, key.strip(), _parse_scalar(val.strip()))
    return tree


def load_config(
    config: Union[str, Dict[str, Any], None] = None,
    overrides: Optional[Sequence[str]] = None,
    mode: str = "train_dist",
) -> CoreArgs:
    """A YAML path (or dict) + overrides -> validated CoreArgs."""
    if config is None:
        tree: Dict[str, Any] = {}
    elif isinstance(config, str):
        tree = _load_yaml(config)
    else:
        tree = dict(config)
    if overrides:
        tree = _deep_merge(tree, parse_overrides(overrides))
    tree.setdefault("mode", mode)
    return CoreArgs.from_tree(tree)


def args_from_cli(argv: Sequence[str], mode: str) -> CoreArgs:
    """``python -m ...cli.<launcher> <config.yaml> [key=value ...]``."""
    cfg_path: Optional[str] = None
    overrides: List[str] = []
    for a in argv:
        if cfg_path is None and "=" not in a and (a.endswith(".yaml")
                                                  or a.endswith(".yml")):
            cfg_path = a
        else:
            overrides.append(a)
    return load_config(cfg_path, overrides, mode)
