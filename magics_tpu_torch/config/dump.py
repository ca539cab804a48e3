"""`--dump-default` support (main.rs:117-180 parity): emit the schema
defaults as TOML (config) / YAML (formation, environment)."""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Any


def _kebab(name: str) -> str:
    return name.replace("_", "-")


def to_plain(obj: Any) -> Any:
    """Dataclass tree -> nested dict with kebab-case keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            _kebab(f.name): to_plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def to_toml(d: dict, prefix: str = "") -> str:
    """Minimal nested-table TOML emitter (values: scalar/list/dict)."""
    scalars = {k: v for k, v in d.items() if not isinstance(v, dict)}
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    out = []
    for k, v in scalars.items():
        out.append(f"{k} = {_toml_value(v)}")
    for k, v in tables.items():
        name = f"{prefix}{k}"
        out.append("")
        out.append(f"[{name}]")
        out.append(to_toml(v, prefix=f"{name}."))
    return "\n".join(s for s in out).strip("\n")


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-encode {type(v)}")


def default_config_toml() -> str:
    from magics_tpu_torch.config.schema import Config

    d = to_plain(Config())
    d.pop("raw", None)
    return to_toml(d) + "\n"


def default_formation_yaml() -> str:
    """The reference's FormationGroup::default() (gbp_config/src/
    formation.rs:735-766): one formation of 1 robot crossing the map."""
    import yaml

    return yaml.safe_dump(
        {
            "formations": [
                {
                    "repeat": None,
                    "delay": {"secs": 5, "nanos": 0},
                    "robots": 1,
                    "planning-strategy": "only-local",
                    "initial-position": {
                        "shape": {
                            "line-segment": [
                                {"x": 0.4, "y": 0.0},
                                {"x": 0.6, "y": 0.0},
                            ]
                        },
                        "placement-strategy": "random",
                    },
                    "waypoints": [
                        {
                            "shape": {
                                "line-segment": [
                                    {"x": 0.4, "y": 0.4},
                                    {"x": 0.6, "y": 0.6},
                                ]
                            },
                            "projection-strategy": "identity",
                        },
                    ],
                }
            ]
        },
        sort_keys=False,
    )


def default_environment_yaml() -> str:
    """Environment::default(): a single empty tile."""
    import yaml

    return yaml.safe_dump(
        {
            "tiles": {
                "grid": ["█"],
                "settings": {
                    "tile-size": 100.0,
                    "path-width": 0.1325,
                    "obstacle-height": 1.0,
                    "sdf": {"resolution": 80, "expansion": 0.1, "blur": 0.01},
                },
            },
            "obstacles": [],
        },
        sort_keys=False,
    )


def json_yaml(doc: Any) -> str:
    """`doc` (dicts, lists, strings, numbers, bools, None) as a JSON
    document that PyYAML reads as the same tree: an `environment.yaml` or
    `formation.yaml` written without PyYAML (`env.model.load_yaml`). PyYAML
    reads YAML 1.1, where a float needs a dot and a signed exponent
    (`1e-05` is a string there), so every float is written so: 1.0e-05."""
    if isinstance(doc, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {json_yaml(v)}"
                               for k, v in doc.items()) + "}"
    if isinstance(doc, (list, tuple)):
        return "[" + ", ".join(json_yaml(v) for v in doc) + "]"
    if isinstance(doc, float):
        if not math.isfinite(doc):
            raise ValueError(f"JSON has no {doc}")
        mantissa, e, exponent = repr(doc).partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (f"e{int(exponent):+03d}" if e else "")
    return json.dumps(doc)
