"""Cadenza recipe configuration: config.yaml -> namespace, without PyYAML.

The port's counterpart of cadenza/config.py: the same schema (paths, sample
rates, NAL-R and compressor parameters, batch sharding), with the
separator's `device` ("cuda" or "cpu") in place of `runtime_backend`. The
defaults are this directory's config.yaml. PyYAML is not among the card
machine's packages, so the YAML here, nested maps of scalars, is read by
`parse_yaml`, which takes that subset and raises on anything else.
"""

import copy
import re
from pathlib import Path
from types import SimpleNamespace

DEFAULT_YAML = Path(__file__).with_name("config.yaml")


def _scalar(text: str):
    """A YAML plain or quoted scalar: null, booleans, ints, floats, strings."""
    if not text:
        return None
    if text[0] in "'\"":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"unterminated quoted string: {text}")
        return text[1:-1]
    low = text.lower()
    if low in ("null", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    if re.fullmatch(r"[-+]?\d+", text):
        return int(text)
    if re.fullmatch(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?", text):
        return float(text)
    return text


def _strip_comment(line: str) -> str:
    """The line without a trailing `# comment` outside quotes."""
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


def parse_yaml(text: str) -> dict:
    """Nested block maps of scalars (`key: value`, `key:` opening a map
    indented deeper), comments and blank lines: the subset config.yaml
    uses. Raises ValueError on any other construct (lists, flow maps,
    multi-line strings, tabs)."""
    root: dict = {}
    stack = [(-1, root)]                      # (indent, map)
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {lineno}: tabs in indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        m = re.fullmatch(r"([A-Za-z_][\w.-]*)\s*:(?:\s+(.*))?", body) or re.fullmatch(r"([A-Za-z_][\w.-]*):", body)
        if not m or body.startswith(("- ", "{", "[")):
            raise ValueError(f"line {lineno}: not a `key: value` line: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key, value = m.group(1), (m.group(2) if m.lastindex and m.lastindex >= 2 else None)
        if key in parent:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        if value is None or value == "":
            parent[key] = {}
            stack.append((indent, parent[key]))
        else:
            if value[0] in "{[|>&*!":
                raise ValueError(f"line {lineno}: unsupported YAML value {value!r}")
            parent[key] = _scalar(value)
    # a `key:` with nothing nested under it is null, as in YAML
    return _nulls(root)


def _nulls(d):
    if isinstance(d, dict):
        return {k: (None if v == {} else _nulls(v)) for k, v in d.items()}
    return d


def _ns(d):
    if isinstance(d, dict):
        return SimpleNamespace(**{k: _ns(v) for k, v in d.items()})
    return d


def _interp_paths(paths: dict) -> dict:
    out = dict(paths)
    for _ in range(3):
        for k, v in out.items():
            if isinstance(v, str):
                out[k] = v.format(**{kk: vv for kk, vv in out.items() if isinstance(vv, str)})
    return out


def load_config(yaml_path: str = None, overrides: dict = None) -> SimpleNamespace:
    """config.yaml's defaults, merged with the YAML file `yaml_path` and
    then the dict `overrides`; `{name}` references among the paths resolved."""
    cfg = copy.deepcopy(parse_yaml(DEFAULT_YAML.read_text()))

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    if yaml_path:
        if not Path(yaml_path).exists():
            raise FileNotFoundError(f"config file not found: {yaml_path}")
        merge(cfg, parse_yaml(Path(yaml_path).read_text()))
    if overrides:
        merge(cfg, overrides)
    cfg["path"] = _interp_paths(cfg["path"])
    return _ns(cfg)
