"""Model registry.

Port of recbole_tpu/models/__init__.py. Models self-register with
@register_model at import time; get_model imports the category packages
lazily on first lookup (case-insensitive, exact-case preferred). Ported so
far: the general family's BPR, the context family's base with DeepFM, FM
and LR, and the sequential family's base with SASRec. Any other name raises
``ValueError`` from ``get_model``; the other 11 context models, the other 24
sequential models and the remaining families are ROADMAP Queue 1.
"""

import importlib
import pkgutil

_REGISTRY = {}
_LOADED = False
_CATEGORIES = ("general", "context", "sequential")


def register_model(name):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.model_name = name
        return cls
    return deco


def _load_all():
    global _LOADED
    if _LOADED:
        return
    for cat in _CATEGORIES:
        pkg = importlib.import_module(f"{__name__}.{cat}")
        for mod in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{__name__}.{cat}.{mod.name}")
    _LOADED = True


def get_model(name):
    _load_all()
    if name in _REGISTRY:
        return _REGISTRY[name]
    lowered = {k.lower(): v for k, v in _REGISTRY.items()}
    if name.lower() in lowered:
        return lowered[name.lower()]
    raise ValueError(f"model {name!r} not found; known: {sorted(_REGISTRY)}")


def model_names():
    _load_all()
    return sorted(_REGISTRY)
