from .node import ConfigNode
from .config import (
    cfg_from_args,
    default_cfg,
    make_cfg,
    make_parser,
    parse_cfg,
)

__all__ = [
    "ConfigNode",
    "cfg_from_args",
    "default_cfg",
    "make_cfg",
    "make_parser",
    "parse_cfg",
]
