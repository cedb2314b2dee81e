"""Typed configuration (the interseg, stat_fish, metaseg, meta_overlay and
fish_distance_calculation sections of the reference's ``config.yaml``,
reference config.yaml:1-19) and the stat_fish expert knobs
(``stat_fish_params.yaml``).  Same schema and errors as
``ecseg_tpu/core/config.py``; the port's default knobs are its own copy of
that package's ``stat_fish_params.yaml`` (``ecseg_torch/stat_fish_params.yaml``).

The files are read by :func:`parse_yaml_subset`, not PyYAML, so the port
needs no YAML package: the subset of YAML that ``config.yaml`` and
``stat_fish_params.yaml`` use, resolved as ``yaml.safe_load`` resolves it.
Anything outside the subset raises :class:`ConfigError` naming the file and
line; the reader never guesses."""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Mapping, Optional, Tuple


class ConfigError(RuntimeError):
    """Raised for invalid or missing configuration values."""


def _require(section: Mapping[str, Any], key: str, task: str) -> Any:
    if key not in section:
        raise ConfigError(f"config section '{task}' is missing required key '{key}'")
    return section[key]


@dataclasses.dataclass(frozen=True)
class MetasegConfig:
    """reference config.yaml:14-15."""

    inpath: str


@dataclasses.dataclass(frozen=True)
class MetaOverlayConfig:
    """reference config.yaml:10-12; sensitivity validated 0-255
    (reference meta_overlay.py:34-36)."""

    inpath: str
    color_sensitivity: int

    def __post_init__(self):
        if self.color_sensitivity < 0 or self.color_sensitivity > 255:
            raise ConfigError("color_sensitivity can only be between 0 and 255")


@dataclasses.dataclass(frozen=True)
class StatFishConfig:
    """reference config.yaml:5-9."""

    inpath: str
    scale: Any  # a number or the string 'auto' (reference stat_fish.py:228)
    use_min_cut: bool
    nuclei_size_T: int


@dataclasses.dataclass(frozen=True)
class IntersegConfig:
    """reference config.yaml:1-4; FISH_color validated at interseg.py:59-61."""

    inpath: str
    FISH_color: str
    has_centromeric_probe: bool

    def __post_init__(self):
        if self.FISH_color.lower() not in ("green", "red"):
            # the reference's full wording (interseg.py:60): interseg prints
            # this message when it exits, so it carries the guidance
            raise ConfigError(
                'FISH_color can only be "green" or "red". '
                "Please update the config.yaml file accordingly."
            )

    @property
    def fish_index(self) -> int:
        """Channel index of the target FISH probe (reference interseg.py:63-67)."""
        return 1 if self.FISH_color.lower() == "green" else 0


@dataclasses.dataclass(frozen=True)
class FishDistanceConfig:
    """reference config.yaml:16-19."""

    inpath: str
    centromere_probe_color: str
    fish_probe_color: str
    max_centromeric_spots: int

    _COLOR_TO_INDEX = {"red": 0, "green": 1, "blue": 2}

    @property
    def centromere_probe_index(self) -> int:
        return self._COLOR_TO_INDEX[self.centromere_probe_color]

    @property
    def fish_probe_index(self) -> int:
        return self._COLOR_TO_INDEX[self.fish_probe_color]


@dataclasses.dataclass(frozen=True)
class Config:
    raw: Mapping[str, Any]
    path: Optional[str] = None

    def _section(self, task: str) -> Mapping[str, Any]:
        if task not in self.raw or self.raw[task] is None:
            raise ConfigError(f"config has no '{task}' section")
        return self.raw[task]

    @property
    def metaseg(self) -> MetasegConfig:
        s = self._section("metaseg")
        return MetasegConfig(inpath=_require(s, "inpath", "metaseg"))

    @property
    def meta_overlay(self) -> MetaOverlayConfig:
        s = self._section("meta_overlay")
        return MetaOverlayConfig(
            inpath=_require(s, "inpath", "meta_overlay"),
            color_sensitivity=_require(s, "color_sensitivity", "meta_overlay"),
        )

    @property
    def stat_fish(self) -> StatFishConfig:
        s = self._section("stat_fish")
        return StatFishConfig(
            inpath=_require(s, "inpath", "stat_fish"),
            scale=_require(s, "scale", "stat_fish"),
            use_min_cut=_require(s, "use_min_cut", "stat_fish"),
            nuclei_size_T=_require(s, "nuclei_size_T", "stat_fish"),
        )

    @property
    def interseg(self) -> IntersegConfig:
        s = self._section("interseg")
        return IntersegConfig(
            inpath=_require(s, "inpath", "interseg"),
            FISH_color=_require(s, "FISH_color", "interseg"),
            has_centromeric_probe=_require(s, "has_centromeric_probe", "interseg"),
        )

    @property
    def fish_distance_calculation(self) -> FishDistanceConfig:
        task = "fish_distance_calculation"
        s = self._section(task)
        return FishDistanceConfig(
            inpath=_require(s, "inpath", task),
            centromere_probe_color=_require(s, "centromere_probe_color", task),
            fish_probe_color=_require(s, "fish_probe_color", task),
            max_centromeric_spots=_require(s, "max_centromeric_spots", task),
        )


def load_config(path: str = "config.yaml") -> Config:
    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        raw = parse_yaml_subset(f.read(), path)
    if not isinstance(raw, Mapping):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    return Config(raw=raw, path=os.path.abspath(path))


@dataclasses.dataclass(frozen=True)
class StatFishParams:
    """Expert knobs (reference src/stat_fish_params.yaml:1-21); the defaults
    are the reference's shipped values."""

    normal_threshold: float = 15
    color_sensitivity: tuple = (70, 70)
    cell_size_threshold_coeff: float = 1.25
    flow_limit: int = 60
    line_thickness: int = 2
    min_score: float = 0.95
    nms_threshold: float = 0.01
    scale_ratio: float = 0.3
    min_cc_size: int = 7
    gaussian_sigma: float = 3
    kernel_size: tuple = (7, 7)
    target_median_nuclei_size: float = 2500
    # the file these knobs were read from (None: the defaults); stat_fish
    # copies it into its output, so the copy holds the values used
    path: Optional[str] = None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "StatFishParams":
        kwargs = {}
        for field in dataclasses.fields(cls):
            if field.name in m:
                v = m[field.name]
                kwargs[field.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)


def default_params_path() -> str:
    """The port's copy of the shipped ``stat_fish_params.yaml``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "stat_fish_params.yaml")


def load_stat_fish_params(path: Optional[str] = None) -> StatFishParams:
    if path is None:
        path = default_params_path()
    if not os.path.exists(path):
        return StatFishParams()
    with open(path) as f:
        raw = parse_yaml_subset(f.read(), path) or {}
    return dataclasses.replace(StatFishParams.from_mapping(raw), path=os.path.abspath(path))


# --------------------------------------------------------------------------
# the YAML subset
# --------------------------------------------------------------------------
#
# Taken: comments, blank lines, block mappings nested by spaces, plain
# scalars, single-quoted scalars, double-quoted scalars without escapes,
# and one-line flow lists of plain scalars.  Plain scalars resolve as in
# PyYAML's safe_load (YAML 1.1): decimal int, float with a dot, bool, null,
# else str.  Refused: tabs, block lists, flow mappings, anchors, aliases,
# tags, block and multi-line scalars, document markers, directives,
# duplicate keys, and plain scalars that safe_load would read as another
# type (octal, hex, binary, base 60, underscores, .inf, .nan, dates).

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = {"", "~", "null", "Null", "NULL"}
# not taken anywhere in a flow list's scalar (PyYAML's flow scanner reads
# some of them as structure)
_FLOW_INDICATORS = frozenset(",[]{}:?#&*!|>'\"%@`")
# what safe_load resolves to a number or a date in forms the subset leaves
# out (PyYAML's resolver patterns, widened to any such prefix for dates)
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+\Z|[-+]?0[0-7_]+\Z|[-+]?0x[0-9a-fA-F_]+\Z"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?\Z"
    r"|[-+]?(?:0|[1-9][0-9_]*)\Z|(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+][0-9]+)?\Z"
    r"|[-+]?\.(?:inf|Inf|INF)\Z|\.(?:nan|NaN|NAN)\Z|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<\Z|=\Z"
)


def _fail(path: str, line: int, what: str):
    raise ConfigError(f"{path}:{line}: {what} (outside the YAML subset this reader takes)")


def _plain(text: str, path: str, line: int, flow: bool = False) -> Any:
    """A plain scalar, resolved as safe_load resolves it."""
    if text[:1] in "[]{}#&*!|>'\"%@`," or text in ("-", "?", ":") or text[:2] in ("- ", "? ", ": "):
        _fail(path, line, f"the scalar {text!r} starts with an indicator")
    if ": " in text or text.endswith(":") or (flow and any(ch in text for ch in _FLOW_INDICATORS)):
        _fail(path, line, f"the scalar {text!r} holds a mapping or flow indicator")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _OTHER.match(text):
        _fail(path, line, f"the scalar {text!r} is a number or date in a form the reader does not resolve")
    return text


def _quoted(text: str, path: str, line: int) -> Tuple[str, str]:
    """(the string, the rest of the line) of a quoted scalar at the start of
    ``text``: single-quoted with ``''`` for a quote, or double-quoted with no
    backslash escapes, on one line."""
    q = text[0]
    i, out = 1, []
    while True:
        j = text.find(q, i)
        if j < 0:
            _fail(path, line, "a quoted scalar that does not end on its line")
        out.append(text[i:j])
        if q == "'" and text[j + 1 : j + 2] == "'":
            out.append("'")
            i = j + 2
            continue
        s = "".join(out)
        if q == '"' and "\\" in s:
            _fail(path, line, "a double-quoted scalar with escapes")
        return s, text[j + 1 :]


def _value(text: str, path: str, line: int) -> Any:
    if text[:1] in "'\"":
        s, rest = _quoted(text, path, line)
        if rest.strip():
            _fail(path, line, f"text after a quoted scalar: {rest.strip()!r}")
        return s
    if text[:1] == "[":
        if not text.endswith("]"):
            _fail(path, line, "a flow list that does not end on its line")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [t.strip() for t in inner.split(",")]
        if "" in items:
            _fail(path, line, f"an empty entry in the flow list {text!r}")
        return [_plain(t, path, line, flow=True) for t in items]
    return _plain(text, path, line)


def _strip_comment(line: str) -> str:
    """The line without its comment: ``#`` at its start or after a space,
    outside a quoted key or value (one that opens the line or follows
    ``": "``)."""
    quote = None
    first = len(line) - len(line.lstrip(" "))
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == first or (line[i - 1] == " " and line[:i].rstrip(" ").endswith(":"))):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i]
    return line


def _entries(text: str, path: str) -> List[Tuple[int, int, Any, Optional[str]]]:
    """(line number, indent, key, value text or None) per mapping entry."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            _fail(path, n, "a tab")
        content = _strip_comment(raw).rstrip()
        body = content.lstrip(" ")
        if not body:
            continue
        if body in ("---", "...") or body.startswith(("--- ", "... ", "%")):
            _fail(path, n, "a document marker or directive")
        if body[:1] in "'\"":
            key, rest = _quoted(body, path, n)
        else:
            m = re.search(r":(?: |\Z)", body)
            if m is None or m.start() == 0:
                _fail(path, n, f"a line that is not 'key: value' ({body!r})")
            key, rest = _plain(body[: m.start()].rstrip(), path, n), body[m.start() :]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            _fail(path, n, f"a line that is not 'key: value' ({body!r})")
        value = rest[1:].strip()
        out.append((n, len(content) - len(body), key, value or None))
    return out


def _mapping(entries, i: int, indent: int, path: str) -> Tuple[dict, int]:
    """The block mapping whose keys sit at ``indent`` from entry ``i``;
    returns it and the index of the first entry after it."""
    out = {}
    while i < len(entries) and entries[i][1] >= indent:
        n, ind, key, value = entries[i]
        if ind != indent:
            _fail(path, n, "an indented line that continues no mapping key")
        if key in out:
            _fail(path, n, f"the duplicate key {key!r}")
        i += 1
        if value is not None:
            out[key] = _value(value, path, n)
        elif i < len(entries) and entries[i][1] > indent:
            out[key], i = _mapping(entries, i, entries[i][1], path)
        else:
            out[key] = None
    return out, i


def parse_yaml_subset(text: str, path: str = "<string>") -> Any:
    """The document of ``text`` as ``yaml.safe_load`` gives it, for the
    subset above (None for a document with no entries); ``path`` names the
    file in errors."""
    entries = _entries(text, path)
    if not entries:
        return None
    out, i = _mapping(entries, 0, entries[0][1], path)
    if i < len(entries):
        _fail(path, entries[i][0], "a line indented less than the document's first key")
    return out
