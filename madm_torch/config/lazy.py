"""Detectron2-LazyConfig-style configuration system, dependency-free (a copy
of ``madm_tpu/config/lazy.py``, which is pure Python; the port keeps its own
so that it imports nothing of the JAX package).

The reference builds its whole model graph from Python config files composing
``LazyCall`` nodes into an OmegaConf tree and instantiating them recursively
(reference: config usage in ``config_files/common/models/mtmadise_multi_lora.py``
and ``config/instantiate.py:4-11``).  This module reproduces that public
surface — ``LazyCall`` / ``instantiate`` / ``LazyConfig.load`` /
``LazyConfig.apply_overrides`` / ``'???'`` required markers — without
detectron2 or omegaconf.  The port's config files live in
``madm_torch/configs/``.

Config nodes are plain ``ConfigDict`` objects (attribute-style dicts).  A node
produced by ``LazyCall(fn)(**kwargs)`` carries the callable under ``_target_``.
"""

from __future__ import annotations

import ast
import copy
import importlib
import importlib.util
import os
import uuid
from typing import Any, Callable

MISSING = "???"


class ConfigDict(dict):
    """Attribute-accessible dict used for all config nodes."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        out = type(self)()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


class LazyCall:
    """``LazyCall(fn)(a=1)`` records a deferred call as a config node.

    Mirrors ``detectron2.config.LazyCall`` semantics used throughout the
    reference's ``config_files/``.
    """

    def __init__(self, target: Callable):
        if not callable(target):
            raise TypeError(f"LazyCall target must be callable, got {target!r}")
        self._target = target

    def __call__(self, **kwargs) -> ConfigDict:
        node = ConfigDict(kwargs)
        node["_target_"] = self._target
        return node


def _resolve_target(target: Any) -> Callable:
    if callable(target):
        return target
    if isinstance(target, str):
        module, _, name = target.rpartition(".")
        return getattr(importlib.import_module(module), name)
    raise TypeError(f"Cannot resolve _target_: {target!r}")


def instantiate(cfg: Any, _path: str = "cfg") -> Any:
    """Recursively instantiate a tree of LazyCall nodes.

    Lists/tuples/dicts are traversed; a dict with ``_target_`` becomes a call.
    ``'???'`` anywhere raises, naming the offending key.
    """
    if isinstance(cfg, (list, tuple)):
        vals = [instantiate(v, f"{_path}[{i}]") for i, v in enumerate(cfg)]
        return type(cfg)(vals) if isinstance(cfg, tuple) else vals
    if isinstance(cfg, dict):
        kwargs = {
            k: instantiate(v, f"{_path}.{k}") for k, v in cfg.items() if k != "_target_"
        }
        if "_target_" in cfg:
            target = _resolve_target(cfg["_target_"])
            return target(**kwargs)
        out = ConfigDict(kwargs) if isinstance(cfg, ConfigDict) else dict(kwargs)
        return out
    if isinstance(cfg, str) and cfg == MISSING:
        raise ValueError(f"Required config value {_path} is unset ('???')")
    return cfg


def _split_path(dotpath: str):
    # supports a.b.c and a.b[0].c
    parts = []
    for seg in dotpath.split("."):
        while "[" in seg:
            head, rest = seg.split("[", 1)
            idx, seg_rest = rest.split("]", 1)
            if head:
                parts.append(head)
            parts.append(int(idx))
            seg = seg_rest.lstrip(".")
        if seg:
            parts.append(seg)
    return parts


def get_by_path(cfg: Any, dotpath: str) -> Any:
    node = cfg
    for p in _split_path(dotpath):
        node = node[p]
    return node


def set_by_path(cfg: Any, dotpath: str, value: Any) -> None:
    parts = _split_path(dotpath)
    node = cfg
    for p in parts[:-1]:
        nxt = node[p] if (isinstance(p, int) or p in node) else None
        if nxt is None:
            nxt = ConfigDict()
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


class LazyConfig:
    """Loader for Python config files (reference: detectron2 LazyConfig)."""

    @staticmethod
    def load(filename: str) -> ConfigDict:
        """Execute a Python config file; module-level vars become the config.

        Relative imports between config files (``from ...common.train import
        train``) are supported by loading the file as part of a synthetic
        package rooted at the config tree root.
        """
        filename = os.path.abspath(filename)
        if not filename.endswith(".py"):
            raise ValueError(f"Config file must be .py: {filename}")

        # Root the synthetic package at the topmost directory that still
        # contains __init__-less config dirs: use the directory depth implied
        # by the relative imports. Simpler: walk up while parent dirs exist and
        # register each level as a namespace package.
        root = os.path.dirname(filename)
        levels = [os.path.basename(filename)[:-3]]
        while os.path.basename(root) and any(
            os.path.isdir(os.path.join(root, d)) for d in ("common", "SemSeg")
        ) or os.path.basename(root) in ("common", "SemSeg", "MTMADISE", "models", "data"):
            levels.insert(0, os.path.basename(root))
            root = os.path.dirname(root)

        pkg_prefix = "_madm_cfg_" + uuid.uuid4().hex[:8]
        import sys

        # register namespace packages for each level (incl. the bare prefix)
        for i in range(len(levels)):
            pkg_name = ".".join([pkg_prefix] + levels[:i])
            if pkg_name in sys.modules:
                continue
            spec = importlib.util.spec_from_loader(pkg_name, loader=None, is_package=True)
            mod = importlib.util.module_from_spec(spec)
            mod.__path__ = [os.path.join(root, *levels[:i])]
            sys.modules[pkg_name] = mod

        mod_name = ".".join([pkg_prefix] + levels)
        spec = importlib.util.spec_from_file_location(mod_name, filename)
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)

        cfg = ConfigDict()
        for name, value in vars(module).items():
            if name.startswith("_"):
                continue
            if isinstance(value, (ConfigDict, dict, list, tuple, int, float, str, bool, type(None))):
                cfg[name] = value
        return cfg

    @staticmethod
    def apply_overrides(cfg: ConfigDict, overrides) -> ConfigDict:
        """Apply ``a.b.c=value`` dot-path overrides (values literal-eval'd)."""
        for ov in overrides or []:
            key, _, raw = ov.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            set_by_path(cfg, key.strip(), value)
        return cfg

    @staticmethod
    def to_py(cfg: Any, prefix: str = "cfg.") -> str:
        """Dump a readable repr of the config for logging."""
        lines = []

        def _dump(node, path):
            if isinstance(node, dict):
                tgt = node.get("_target_")
                if tgt is not None:
                    name = getattr(tgt, "__qualname__", str(tgt))
                    lines.append(f"{path} = LazyCall({name})")
                for k, v in node.items():
                    if k == "_target_":
                        continue
                    _dump(v, f"{path}.{k}")
            elif isinstance(node, (list, tuple)):
                if all(not isinstance(v, (dict, list, tuple)) for v in node):
                    lines.append(f"{path} = {node!r}")
                else:
                    for i, v in enumerate(node):
                        _dump(v, f"{path}[{i}]")
            else:
                lines.append(f"{path} = {node!r}")

        _dump(cfg, prefix.rstrip("."))
        return "\n".join(lines)
