"""Carry weights between the JAX package's parameter trees and the port's modules.

The port keeps the JAX layouts (``wx`` [D, 4H], ``wh`` [H, 4H], ``b`` [4H],
gate order i, f, g, o; ``out_w`` [hidden, C], ``out_b`` [C]) as its own
parameter layout, so nothing is transposed at the boundary: a JAX tree

    {"nnet": {"layers": [{"fwd": {wx, wh, b}, "bwd": {...}}, ...]},
     "out_w": ..., "out_b": ...}

(pykaldi2_tpu/models/lstm.py:31-43, nnet_am.py:30-38) maps onto the
``NnetAM`` state_dict keys ``nnet.layers.0.fwd.wx`` … ``out_w``, ``out_b``.
``keystr`` spells a tree path the way the JAX package's npz checkpoints name
their entries (``['nnet']['layers'][0]['fwd']['wh']``), so the port's
checkpoints load in either package.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]


def walk(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in the JAX package's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def keystr(path: Path) -> str:
    """``('nnet', 'layers', 0, 'fwd', 'wh')`` → ``"['nnet']['layers'][0]['fwd']['wh']"``."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → the port's NnetAM state_dict."""
    return {".".join(str(p) for p in path): torch.as_tensor(np.array(leaf, np.float32))
            for path, leaf in walk(tree)}


def unflatten(items: Iterable[Tuple[Path, Any]]) -> dict:
    """(path, leaf) pairs → nested dicts, with lists where a path step is an int."""
    tree: dict = {}
    for parts, leaf in items:
        node = tree
        for p, nxt in zip(parts[:-1], parts[1:]):
            if isinstance(p, int):
                while len(node) <= p:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[p]
            else:
                node = node.setdefault(p, [] if isinstance(nxt, int) else {})
        node[parts[-1]] = leaf
    return tree


def params_to_jax(state_dict) -> dict:
    """The port's NnetAM state_dict → JAX parameter tree of numpy arrays."""
    return unflatten(
        (tuple(int(p) if p.isdigit() else p for p in name.split(".")),
         value.detach().to("cpu", torch.float32).numpy())
        for name, value in state_dict.items())
