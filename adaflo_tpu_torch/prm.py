"""deal.II-style parameter file (.prm) and .json input handling.

Behavioral parity with deal.II's ParameterHandler as used by the reference
(source/parameters.cc:423-448): ``subsection X`` / ``set k = v``
/ ``end`` syntax, ``#`` comments, declared defaults, unknown entries rejected.
Implemented from scratch for this framework.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class PrmError(Exception):
    pass


@dataclass
class _Entry:
    default: str
    pattern: Optional[str] = None  # regex or None ("anything")
    doc: str = ""
    value: Optional[str] = None

    def get(self) -> str:
        return self.default if self.value is None else self.value


@dataclass
class _Section:
    entries: Dict[str, _Entry] = field(default_factory=dict)
    subsections: Dict[str, "_Section"] = field(default_factory=dict)


class ParameterHandler:
    """Minimal re-implementation of the declare/parse/get API surface the
    drivers need. Selection patterns are given as 'a|b|c' strings."""

    def __init__(self) -> None:
        self._root = _Section()
        self._path: list[str] = []

    # ---- declaration -----------------------------------------------------
    def _current(self) -> _Section:
        sec = self._root
        for name in self._path:
            sec = sec.subsections.setdefault(name, _Section())
        return sec

    def enter_subsection(self, name: str) -> None:
        self._path.append(name)
        self._current()  # materialize

    def leave_subsection(self) -> None:
        if not self._path:
            raise PrmError("leave_subsection called at root")
        self._path.pop()

    def declare_entry(
        self, name: str, default: str, pattern: Optional[str] = None, doc: str = ""
    ) -> None:
        self._current().entries[name] = _Entry(default, pattern, doc)

    # ---- access ----------------------------------------------------------
    def get(self, name: str) -> str:
        sec = self._current()
        if name not in sec.entries:
            raise PrmError(f"Unknown parameter '{name}' in {self._path}")
        return sec.entries[name].get()

    def get_double(self, name: str) -> float:
        return float(self.get(name))

    def get_integer(self, name: str) -> int:
        return int(float(self.get(name)))

    def get_bool(self, name: str) -> bool:
        return self.get(name).strip().lower() in ("1", "true", "yes", "on")

    # ---- parsing ---------------------------------------------------------
    def _set_checked(self, sec: _Section, path: list[str], key: str, value: str) -> None:
        if key not in sec.entries:
            raise PrmError(f"Unknown entry 'set {key}' in subsection {path}")
        entry = sec.entries[key]
        if entry.pattern is not None and "|" in entry.pattern:
            allowed = [o.strip() for o in entry.pattern.split("|")]
            if value.strip() not in allowed:
                raise PrmError(
                    f"Value '{value}' for '{key}' not in selection {allowed}"
                )
        entry.value = value.strip()

    def parse_input_string(self, text: str) -> None:
        stack: list[_Section] = [self._root]
        names: list[str] = []
        # handle line continuations
        text = text.replace("\\\n", " ")
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^subsection\s+(.*)$", line, re.IGNORECASE)
            if m:
                name = m.group(1).strip()
                sec = stack[-1].subsections.get(name)
                if sec is None:
                    raise PrmError(f"Unknown subsection '{name}' in {names}")
                stack.append(sec)
                names.append(name)
                continue
            if re.match(r"^end\s*$", line, re.IGNORECASE):
                if len(stack) == 1:
                    raise PrmError("'end' without matching 'subsection'")
                stack.pop()
                names.pop()
                continue
            m = re.match(r"^set\s+(.*?)\s*=\s*(.*)$", line, re.IGNORECASE)
            if m:
                self._set_checked(stack[-1], names, m.group(1).strip(), m.group(2))
                continue
            raise PrmError(f"Cannot parse line: '{raw}'")
        if len(stack) != 1:
            raise PrmError("Unbalanced subsection/end")

    def parse_input(self, filename: str) -> None:
        with open(filename) as f:
            self.parse_input_string(f.read())

    def parse_input_from_json(self, filename_or_obj: Any) -> None:
        if isinstance(filename_or_obj, str):
            with open(filename_or_obj) as f:
                data = json.load(f)
        else:
            data = filename_or_obj

        def walk(sec: _Section, node: Dict[str, Any], path: list[str]) -> None:
            for key, val in node.items():
                if isinstance(val, dict):
                    # deal.II json nests entries as {"value": ...} sometimes;
                    # treat dict with "value" key as an entry
                    if "value" in val and key in sec.entries:
                        self._set_checked(sec, path, key, str(val["value"]))
                    else:
                        sub = sec.subsections.get(key)
                        if sub is None:
                            raise PrmError(f"Unknown subsection '{key}' in {path}")
                        walk(sub, val, path + [key])
                else:
                    self._set_checked(sec, path, key, str(val))

        walk(self._root, data, [])

    # ---- printing --------------------------------------------------------
    def print_parameters(self) -> str:
        out: list[str] = []

        def walk(sec: _Section, indent: int) -> None:
            pad = "  " * indent
            for k in sorted(sec.entries):
                out.append(f"{pad}set {k} = {sec.entries[k].get()}")
            for name in sorted(sec.subsections):
                out.append(f"{pad}subsection {name}")
                walk(sec.subsections[name], indent + 1)
                out.append(f"{pad}end")

        walk(self._root, 0)
        return "\n".join(out)
