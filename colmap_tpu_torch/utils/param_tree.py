"""Parameter trees as modules.

colmap_tpu keeps a network's parameters in a pytree: nested dicts (and,
for LightGlue's layers, a list) whose leaves are arrays. The port keeps the
same tree, so that its functions take the same layout as colmap_tpu's, and
wraps it in an ``nn.Module`` (nested ModuleDicts, ModuleLists and
ParameterDicts) so that a network moves between devices as one object.
"""

from __future__ import annotations

import torch
from torch import nn


def tree_module(tree) -> nn.Module:
    """An nn.Module holding a parameter tree; its leaves become parameters
    without gradients, named by their path ("block1.conv1.w")."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([tree_module(t) for t in tree])
    if all(torch.is_tensor(v) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: tree_module(v) for k, v in tree.items()})


def module_tree(module: nn.Module):
    """The parameter tree that tree_module wrapped, with the module's
    current tensors."""
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    if isinstance(module, nn.ParameterDict):
        return {k: v.data for k, v in module.items()}
    return {k: module_tree(m) for k, m in module.items()}


def map_tree(fn, tree):
    """fn applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
