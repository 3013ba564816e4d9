"""ParmParse-style runtime configuration.

Reproduces the reference's AMReX ParmParse CLI surface (SURVEY.md §5
"Config / flag system"): ``tool key=value ... [inputsfile]`` where an
optional inputs file of ``key = value`` lines is merged with command-line
tokens (CLI wins), values may be multi-token lists, and access is typed
(`get`/`query`/list variants).  Sample shapes in
PeleAnalysis Src/InputsSamples/inputs.{grad,condMean,jpdf}.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

Value = List[str]


def parse_inputs_file(path: str) -> Dict[str, Value]:
    out: Dict[str, Value] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if "=" not in line:
                continue
            key, _, rest = line.partition("=")
            out[key.strip()] = rest.split()
    return out


def parse_argv(tokens: Sequence[str]) -> Dict[str, Value]:
    """Parse CLI tokens. A bare first token with no '=' is an inputs file.
    ``key=v1 v2 v3`` style lists are supported (tokens without '=' extend
    the previous key's value)."""
    out: Dict[str, Value] = {}
    cur: Optional[str] = None
    for i, tok in enumerate(tokens):
        if "=" in tok:
            key, _, v = tok.partition("=")
            out[key] = v.split() if v else []
            cur = key
        elif i == 0:
            # inputs file: load first so later CLI tokens override
            out.update(parse_inputs_file(tok))
            cur = None
        elif cur is not None:
            out[cur].append(tok)
        else:
            raise ValueError(f"cannot parse CLI token {tok!r}")
    return out


_ACTIVE: List["ParmParse"] = []   # instances since the CLI cleared it


class ParmParse:
    def __init__(self, table: Union[Dict[str, Value], Dict[str, str], None] = None):
        self.table: Dict[str, Value] = {}
        self.touched: set = set()
        if len(_ACTIVE) < 1000:  # bounded: only the CLI reads + clears this
            _ACTIVE.append(self)
        if table:
            for k, v in table.items():
                if isinstance(v, str):
                    self.table[k] = v.split()
                elif isinstance(v, (list, tuple)):
                    self.table[k] = [str(x) for x in v]
                else:
                    self.table[k] = [str(v)]

    @classmethod
    def from_argv(cls, tokens: Sequence[str]) -> "ParmParse":
        pp = cls()
        pp.table = parse_argv(tokens)
        return pp

    def contains(self, key: str) -> bool:
        self.touched.add(key)
        return key in self.table

    def countval(self, key: str) -> int:
        self.touched.add(key)
        return len(self.table.get(key, []))

    def _raw(self, key: str) -> Value:
        self.touched.add(key)
        if key not in self.table:
            raise KeyError(f"ParmParse: required key '{key}' not found")
        vals = self.table[key]
        if not vals:
            # 'key=' with no value (trailing-= typo or a blank inputs-file
            # line) would otherwise IndexError deep in get_str
            raise KeyError(f"ParmParse: key '{key}' has no value")
        return vals

    # typed get (required) / query (optional with default)
    def get_str(self, key: str) -> str:
        return " ".join(self._raw(key)) if len(self._raw(key)) > 1 else self._raw(key)[0]

    def get_int(self, key: str) -> int:
        return int(self._raw(key)[0])

    def get_float(self, key: str) -> float:
        return float(self._raw(key)[0])

    def query_str(self, key: str, default):
        return self.get_str(key) if self.contains(key) else default

    def query_int(self, key: str, default):
        return self.get_int(key) if self.contains(key) else default

    def query_float(self, key: str, default):
        return self.get_float(key) if self.contains(key) else default

    def query_bool(self, key: str, default: bool) -> bool:
        if not self.contains(key):
            return default
        v = self._raw(key)[0].lower()
        return v not in ("0", "false", "no")

    def get_str_list(self, key: str) -> List[str]:
        return list(self._raw(key))

    def get_int_list(self, key: str) -> List[int]:
        return [int(x) for x in self._raw(key)]

    def get_float_list(self, key: str) -> List[float]:
        return [float(x) for x in self._raw(key)]

    def query_str_list(self, key: str, default):
        return self.get_str_list(key) if self.contains(key) else (
            None if default is None else list(default))

    def query_int_list(self, key: str, default):
        return self.get_int_list(key) if self.contains(key) else (
            None if default is None else list(default))

    def query_float_list(self, key: str, default):
        return self.get_float_list(key) if self.contains(key) else (
            None if default is None else list(default))
