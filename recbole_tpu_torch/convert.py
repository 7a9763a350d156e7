"""Move parameters between the JAX package's param trees and the port's
modules.

A JAX param tree is a dict whose values are arrays, dicts, or lists of
dicts (``mlp_init`` returns a list of ``{"w", "b"}`` layers, ``transformer_init``
a list of 16-leaf layer dicts). Its leaves
are addressed by dotted paths, list positions as numbers:
``params["mlp"][1]["w"]`` is ``"mlp.1.w"``. The port's modules name their
parameters by exactly these paths (``MLPLayers`` in ``models/layers.py``
names layer i's leaves ``<i>.w`` and ``<i>.b``, ``TransformerEncoder`` names
them ``<i>.wq`` ... ``<i>.ln2_b``), so the name map of every
ported model is the identity, and linear weights are (in, out) in
both packages, so no leaf is transposed. A model whose names must differ
gets its own map here when it is ported.

``load_jax_params(model, params)`` copies a tree of numpy arrays into the
module; ``export_params(model)`` gives the tree back. A missing or extra
leaf, or a shape mismatch, raises. The tests use both to run the two
packages from the same weights.
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


def load_jax_params(model, params):
    own = dict(model.named_parameters())
    flat = flatten_tree(params)
    if set(flat) != set(own):
        raise KeyError(f"parameter names differ: module {sorted(own)}, "
                       f"given {sorted(flat)}")
    with torch.no_grad():
        for name, p in own.items():
            src = np.asarray(flat[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {src.shape} vs module {tuple(p.shape)}")
            p.copy_(torch.tensor(src, dtype=p.dtype))
    return model


def export_params(model):
    return unflatten_tree({name: p.detach().cpu().numpy()
                           for name, p in model.named_parameters()})
