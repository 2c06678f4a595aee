"""Layered TOML configuration system.

Counterpart of ``patchperpix_tpu/config.py`` without its stage
flattening, with the validation grid (``named_params``).  Mirrors
the reference's config behavior (run_ppp.py:48-58, 333-373, 1999-2074):
multiple TOML files recursively merged, dotted-path CLI overrides, and
provenance write-back of the merged config into the run directory.
Reading uses stdlib ``tomllib``; writing uses a small serializer below
(there is no ``toml`` package).
"""

from __future__ import annotations

import copy
import datetime
import itertools
import os
import tomllib
from typing import Any, Mapping


def merge_dicts(sink: dict, source: Mapping) -> dict:
    """Recursively merge ``source`` into ``sink`` (reference run_ppp.py:48-58)."""
    if not isinstance(sink, dict) or not isinstance(source, Mapping):
        raise TypeError("merge_dicts expects dict arguments")
    for key, value in source.items():
        if isinstance(value, Mapping) and isinstance(sink.get(key), dict):
            merge_dicts(sink[key], value)
        else:
            sink[key] = copy.deepcopy(value)
    return sink


def load_config(*paths: str | os.PathLike) -> dict:
    """Load one or more TOML files, later files override earlier ones."""
    config: dict = {}
    for path in paths:
        with open(path, "rb") as f:
            merge_dicts(config, tomllib.load(f))
    return config


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(value, datetime.datetime):
        return value.isoformat()
    if isinstance(value, (list, tuple)):
        return "[ " + ", ".join(_toml_value(v) for v in value) + " ]"
    raise TypeError(f"cannot serialize {type(value)} to TOML")


def dump_config(config: Mapping, path: str | os.PathLike) -> None:
    """Write a (possibly nested) dict as TOML for run provenance."""
    lines: list[str] = []

    def emit(table: Mapping, prefix: str) -> None:
        scalars = {k: v for k, v in table.items() if not isinstance(v, Mapping)}
        subtables = {k: v for k, v in table.items() if isinstance(v, Mapping)}
        if prefix:
            lines.append(f"[{prefix}]")
        for key, value in scalars.items():
            if value is None:
                continue
            lines.append(f"{key} = {_toml_value(value)}")
        lines.append("")
        for key, sub in subtables.items():
            emit(sub, f"{prefix}.{key}" if prefix else key)

    emit(config, "")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def set_by_path(config: dict, dotted: str, value: Any) -> None:
    """Set ``config['a']['b'] = value`` from ``"a.b"`` (CLI overrides)."""
    keys = dotted.split(".")
    node = config
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = value


def get_by_path(config: Mapping, dotted: str, default: Any = None) -> Any:
    """Fetch a dotted-path value (e.g. metric keys ``general.avg_f1_cov_score``)."""
    node: Any = config
    for key in dotted.split("."):
        if not isinstance(node, Mapping) or key not in node:
            return default
        node = node[key]
    return node


def named_params(config_section: Mapping) -> list[dict]:
    """Hyperparameter grid: cartesian ``params_product`` x zipped
    ``params_zip`` (run_ppp.py:875-916 named_product / named_zip), the
    parameter dicts ``validate_checkpoints`` sweeps."""
    product_keys = list(config_section.get("params_product", []))
    zip_keys = list(config_section.get("params_zip", []))
    prod_values = [[(key, v) for v in config_section.get(key, [])]
                   for key in product_keys]
    zip_lists = [[(key, v) for v in config_section.get(key, [])]
                 for key in zip_keys]
    zipped = [list(t) for t in zip(*zip_lists)] if zip_lists else [[]]
    out = []
    for combo in itertools.product(*prod_values) if prod_values else [()]:
        for z in zipped:
            out.append(dict(list(combo) + z))
    return out
