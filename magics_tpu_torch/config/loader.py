"""Scenario loading: a scenario directory holds the three-file model
`config.toml` + `environment.yaml` + `formation.yaml`
(reference: crates/magics/src/simulation_loader.rs:128-262)."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

from magics_tpu_torch.config.formation import FormationGroup
from magics_tpu_torch.config.schema import Config
from magics_tpu_torch.env.model import Environment


@dataclasses.dataclass
class Scenario:
    name: str
    config: Config
    environment: Environment
    formations: FormationGroup
    path: Path | None = None


def load_scenario(path: str | os.PathLike) -> Scenario:
    p = Path(path)
    return Scenario(
        name=p.name,
        config=Config.from_file(p / "config.toml"),
        environment=Environment.from_file(p / "environment.yaml"),
        formations=FormationGroup.from_file(p / "formation.yaml"),
        path=p,
    )


def list_scenarios(root: str | os.PathLike) -> list[str]:
    root = Path(root)
    if not root.is_dir():
        return []
    out = []
    for d in sorted(root.iterdir()):
        if d.is_dir() and (d / "config.toml").exists():
            out.append(d.name)
    return out
