"""Move parameters between the JAX package's param trees and the port's
modules.

A JAX param tree is a dict whose values are arrays, dicts, or lists of
dicts (``mlp_init`` returns a list of ``{"w", "b"}`` layers, ``transformer_init``
a list of 16-leaf layer dicts). Its leaves
are addressed by dotted paths, list positions as numbers:
``params["mlp"][1]["w"]`` is ``"mlp.1.w"``. The port's modules name their
parameters by exactly these paths (``MLPLayers`` in ``models/layers.py``
names layer i's leaves ``<i>.w`` and ``<i>.b``, ``TransformerEncoder`` names
them ``<i>.wq`` ... ``<i>.ln2_b``; KGCN's aggregator lists are ``agg_w.<i>``
and ``agg_b.<i>``, MKR's units ``cc.<i>.vv`` ... ``cc.<i>.be``), so the name
map of every ported model is the identity (but for the ``_const`` leaves
below), and linear weights are (in, out) in both packages, so no leaf is
transposed.

``load_jax_params(model, params)`` copies a tree of numpy arrays into the
module; ``export_params(model)`` gives the tree back. A missing or extra
leaf, or a shape mismatch, raises. The tests use both to run the two
packages from the same weights.

A JAX tree's ``_const`` subtree (dataset-derived arrays: a graph operator,
packed-bit images) is skipped both ways: the port rebuilds those arrays from
the dataset as non-persistent buffers of the module. The exception is random
state kept there: the frozen N(0, 1) feature tables of SASRecF, FDSA,
GRU4RecF, DIN and DIEN (``_const.feat_<field>``), and DIN's and DIEN's
frozen id tables (``_const.item_embedding``, DIEN's user side
``_const.user_embedding`` beside its user feature tables), which the module
holds as persistent buffers (``embedder.feat_<field>``,
``embedder.item_embedding``, ``user_embedder.<...>``), and xDeepFM's
frozen CIN weights (``_const.cin.<i>.w`` / ``b``, the buffers
``cin.<i>.w`` / ``b``); a module with a ``const_state_map()`` names
those leaves ({dotted path under ``_const``: state_dict name}), and they
are carried both ways. What the rest of the
tree holds is the module's ``state_dict``: its parameters and its persistent
buffers, the state that is not trained (KGAT's ``edge_attention``). The
tree is loaded through ``load_state_dict``, so a module's own post-hooks
rebuild what derives from it (KGAT's dense blocks, which the JAX tree keeps
under ``_const``).
"""

import numpy as np
import torch

def flatten_tree(tree, prefix=""):
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    flat = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, f"{prefix}{key}."))
    return flat


def unflatten_tree(flat):
    """The inverse of ``flatten_tree``: path parts that are all numbers at
    one level become a list."""
    root = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


CONST_KEY = "_const"


def _const_map(model):
    fn = getattr(model, "const_state_map", None)
    return fn() if fn is not None else {}


def load_jax_params(model, params):
    own = model.state_dict()
    flat = flatten_tree({k: v for k, v in params.items() if k != CONST_KEY})
    const = flatten_tree(params.get(CONST_KEY, {}))
    for leaf, name in _const_map(model).items():
        flat[name] = const[leaf]
    if set(flat) != set(own):
        raise KeyError(f"parameter names differ: module {sorted(own)}, "
                       f"given {sorted(flat)}")
    state = {}
    for name, p in own.items():
        src = np.asarray(flat[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {src.shape} vs module {tuple(p.shape)}")
        state[name] = torch.tensor(src, dtype=p.dtype)
    model.load_state_dict(state)
    return model


def export_params(model):
    state = {name: p.detach().cpu().numpy() for name, p in model.state_dict().items()}
    const = {leaf: state.pop(name) for leaf, name in _const_map(model).items()}
    tree = unflatten_tree(state)
    if const:
        tree[CONST_KEY] = unflatten_tree(const)
    return tree
