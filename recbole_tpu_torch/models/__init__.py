"""Model registry.

Port of recbole_tpu/models/__init__.py. Models self-register with
@register_model at import time; get_model imports the category packages
lazily on first lookup (case-insensitive, exact-case preferred). Ported so
far: the general family's BPR and LightGCN, the context family's base with
DeepFM, FM and LR, the sequential family's base with SASRec, GRU4Rec and
NARM, and the knowledge family's base with RippleNet. The other graph
models of the general family raise ``NotImplementedError`` naming ROADMAP
Queue 1, item 8, and the other seven knowledge models item 9; any other
name raises ``ValueError``; the other 11 context models, the other 22
sequential models and the remaining families are ROADMAP Queue 1.
"""

import importlib
import pkgutil

_REGISTRY = {}
_LOADED = False
_CATEGORIES = ("general", "context", "sequential", "knowledge")
# graph models of the general family that the LightGCN slice left out
_GRAPH_NOT_PORTED = ("NGCF", "SpectralCF", "GCMC", "DGCF")
# knowledge models that the RippleNet slice left out
_KNOWLEDGE_NOT_PORTED = ("CKE", "CFKG", "KTUP", "KGCN", "KGNNLS", "MKR", "KGAT")


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
    if name.lower() in (n.lower() for n in _GRAPH_NOT_PORTED):
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue 1, item 8: "
                                  "the graph models beside LightGCN)")
    if name.lower() in (n.lower() for n in _KNOWLEDGE_NOT_PORTED):
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue 1, item 9: "
                                  "the knowledge models beside RippleNet)")
    raise ValueError(f"model {name!r} not found; known: {sorted(_REGISTRY)}")


def model_names():
    _load_all()
    return sorted(_REGISTRY)
