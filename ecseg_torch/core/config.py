"""Typed configuration (the metaseg section of the reference's ``config.yaml``,
reference config.yaml:14-15).  Same schema and errors as
``ecseg_tpu/core/config.py``; ``yaml`` is imported only when a file is read,
so ``main(config=Config(...))`` runs without it."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional


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


def load_config(path: str = "config.yaml") -> Config:
    import yaml

    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, Mapping):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    return Config(raw=raw, path=os.path.abspath(path))
