"""Config manager: base YAML + optional YAMLs + CLI dotted overrides.

Capability parity with reference contrastyou/configure/config_manager.py:21-133
— merge order base -> opt-paths -> CLI, strict unknown-key rejection, `remove`
sentinel deletion — with one deliberate deviation: **no global mutable scope
registry**. The reference lets distant code read the config through a global
(`get_config("base")` at loss-construction, contrast_loss2.py:168); here the
merged config is passed explicitly.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

from .dictionary_utils import dictionary_merge_by_hierachy, remove_sentinel_keys
from .merge_checker import merge_checker
from .yaml_parser import yamlArgParser
from ..utils.utils import yaml_load


class ConfigManager:
    def __init__(self, base_path: str, *opt_paths: str, strict: bool = True,
                 verbose: bool = False):
        self._base_path = base_path
        self._opt_paths = [p for p in opt_paths if p]
        self._strict = strict
        self._verbose = verbose
        self._cli_config: Dict = {}
        self._parsed_args: Optional[Sequence[str]] = None

    # -- CLI integration -----------------------------------------------------
    def parse_args(self, args: Optional[Sequence[str]] = None) -> "ConfigManager":
        cli_tree, base_path, opt_paths = yamlArgParser().parse(args)
        if base_path:
            self._base_path = base_path
        if opt_paths:
            self._opt_paths = list(self._opt_paths) + opt_paths
        self._cli_config = cli_tree
        return self

    def add_cli_config(self, cli_tree: Dict) -> "ConfigManager":
        self._cli_config = dictionary_merge_by_hierachy(self._cli_config, cli_tree)
        return self

    # -- merged view -----------------------------------------------------------
    @property
    def base_config(self) -> Dict:
        return yaml_load(self._base_path)

    @property
    def merged_config(self) -> Dict:
        config = self.base_config
        for opt in self._opt_paths:
            opt_tree = yaml_load(opt)
            # opt files may introduce new blocks (hook activation by presence),
            # so no strict check against base for them.
            config = dictionary_merge_by_hierachy(config, opt_tree)
        if self._cli_config:
            if self._strict:
                merge_checker(config, self._cli_config)
            config = dictionary_merge_by_hierachy(config, self._cli_config)
        return remove_sentinel_keys(config)

    @property
    def config(self) -> Dict:
        return self.merged_config

    def copy(self) -> "ConfigManager":
        return copy.deepcopy(self)
