from .config import (
    ConfigDict,
    get_config_from_file,
    get_obj_from_str,
    initialize_from_config,
    load_config,
    merge_configs,
)

__all__ = [
    "ConfigDict",
    "get_config_from_file",
    "get_obj_from_str",
    "initialize_from_config",
    "load_config",
    "merge_configs",
]
