"""Scenario configuration: TOML config, environment YAML, formation YAML."""

from magics_tpu_torch.config.schema import Config
from magics_tpu_torch.config.formation import FormationGroup
from magics_tpu_torch.env.model import Environment

__all__ = ["Config", "FormationGroup", "Environment"]
