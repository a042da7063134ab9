from .config_manager import ConfigManager
from .dictionary_utils import (
    dictionary_merge_by_hierachy, extract_dictionary_from_anchor,
    extract_params_with_key_prefix, remove_sentinel_keys, REMOVE_SENTINEL,
)
from .merge_checker import merge_checker, UnknownKeyError
from .yaml_parser import yamlArgParser

__all__ = [
    "ConfigManager", "dictionary_merge_by_hierachy", "extract_dictionary_from_anchor",
    "extract_params_with_key_prefix", "remove_sentinel_keys", "REMOVE_SENTINEL",
    "merge_checker", "UnknownKeyError", "yamlArgParser",
]
