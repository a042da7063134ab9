"""CLI grammar for config overrides.

Capability parity with reference contrastyou/configure/yaml_parser.py:15-106:

    prog Key.Sub=value OtherKey=1.5 --base-path base.yaml --opt-path a.yaml b.yaml

Values are parsed with yaml (so `true`, `1e-3`, `[1,2]` all type naturally);
an explicit `key:!str=10` form forces a type tag.

`yaml` is imported only where a value needs it, so the package imports on a
machine without pyyaml.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _parse_value(raw: str) -> Any:
    # YAML 1.1 does not accept bare scientific notation like `1e-5`; try
    # python numeric parsing first so CLI numbers behave as users expect.
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    import yaml
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _set_dotted(tree: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot set {dotted}: {p} is a leaf")
    node[parts[-1]] = value


def parse_dotted_assignments(tokens: Sequence[str]) -> Dict:
    """Turn `a.b=1 c=[1,2]` tokens into a nested dict."""
    tree: Dict = {}
    for tok in tokens:
        if "=" not in tok:
            raise ValueError(f"expected key=value, got {tok!r}")
        key, raw = tok.split("=", 1)
        if ":!" in key:  # explicit type tag: key:!str=10
            key, tag = key.split(":!", 1)
            import yaml
            value = yaml.safe_load(f"!!{tag} {raw}")
        else:
            value = _parse_value(raw)
        _set_dotted(tree, key, value)
    return tree


class yamlArgParser:
    """argparse wrapper: positional dotted overrides + --base-path/--opt-path."""

    def __init__(self, description: str = "spcl_torch config parser"):
        self._parser = argparse.ArgumentParser(description=description, allow_abbrev=False)
        self._parser.add_argument("overrides", nargs="*", help="dotted Key.Sub=value overrides")
        self._parser.add_argument("--base-path", "--base_path", dest="base_path", default=None)
        self._parser.add_argument("--opt-path", "--opt_path", dest="opt_paths", nargs="*", default=[])

    def parse(self, args: Optional[Sequence[str]] = None) -> Tuple[Dict, Optional[str], List[str]]:
        ns = self._parser.parse_args(args)
        cli_tree = parse_dotted_assignments(ns.overrides)
        return cli_tree, ns.base_path, list(ns.opt_paths)
