"""npz checkpoints with atomic writes and resume, readable by either package.

Port of pykaldi2_tpu/utils/checkpoint.py. Parameters are written under the
same npz keys the JAX package writes, e.g.
``['params']['nnet']['layers'][0]['fwd']['wh']``, in the same layouts, so a
params checkpoint written here loads with ``pykaldi2_tpu.utils.load_checkpoint``
and the reverse. Optimizer state uses the port's own keys
(``['torch_opt'][...]``), which the JAX loader ignores; the JAX package's
``['opt_state']`` entries are likewise ignored here. Metadata goes to a JSON
sidecar (``path.json``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.convert import keystr, params_from_jax, params_to_jax, unflatten, walk

_PARAMS = "['params']"
_OPT = "['torch_opt']"


def _opt_tree(state: dict) -> dict:
    """torch optimizer state → npz-able tree (tensor leaves to numpy)."""
    base = state["base"]
    tree = {"count": np.asarray(state["count"], np.int64),
            "lr_scale": np.asarray(state["lr_scale"], np.float64), "state": {}}
    for idx, st in base["state"].items():
        tree["state"][str(idx)] = {
            k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in st.items() if v is not None}
    return tree


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    meta: Optional[dict] = None):
    """Write params (+ optimizer state) → path(.npz) atomically, meta → path.json."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = {_PARAMS + keystr(p): np.asarray(v)
            for p, v in walk(params_to_jax(model.state_dict()))}
    if optimizer is not None:
        flat.update({_OPT + keystr(p): np.asarray(v)
                     for p, v in walk(_opt_tree(optimizer.state_dict()))})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if meta is not None:
        tmpm = path + ".json.tmp"
        with open(tmpm, "w") as f:
            json.dump(meta, f)
        os.replace(tmpm, path + ".json")


def _unkey(key: str, prefix: str) -> list:
    """``['a'][0]['b']`` → ['a', 0, 'b'] (quoted names stay strings)."""
    return [int(idx) if idx else name
            for name, idx in re.findall(r"\['([^']*)'\]|\[(\d+)\]", key[len(prefix):])]


def _nest(flat: dict, prefix: str) -> dict:
    return unflatten((tuple(_unkey(k, prefix)), v) for k, v in flat.items())


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> dict:
    """Restore params into ``model`` (and optimizer state into ``optimizer``
    when both are given and the file has it); returns the metadata dict."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = {k: v for k, v in flat.items() if k.startswith(_PARAMS)}
    sd = params_from_jax(_nest(params, _PARAMS))
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing}")
    for k, v in sd.items():
        if k in want and tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {tuple(v.shape)} "
                             f"vs model {tuple(want[k].shape)}")
    model.load_state_dict({k: sd[k] for k in want})
    opt = {k: v for k, v in flat.items() if k.startswith(_OPT)}
    if optimizer is not None and opt:
        tree = _nest(opt, _OPT)
        dev = next(model.parameters()).device
        base = optimizer.base.state_dict()
        base["state"] = {
            int(idx): {k: (torch.as_tensor(v) if k == "step" else torch.as_tensor(v).to(dev))
                       for k, v in st.items() if v is not None}
            for idx, st in tree.get("state", {}).items()}
        optimizer.load_state_dict({"base": base, "count": int(tree["count"]),
                                   "lr_scale": float(tree["lr_scale"])})
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return meta


def latest_checkpoint(exp_dir: str, prefix: str = "model") -> Optional[str]:
    """Highest-epoch ``{prefix}.<n>.npz`` in exp_dir, or None."""
    if not os.path.isdir(exp_dir):
        return None
    best, best_n = None, -1
    pat = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.npz$")
    for name in os.listdir(exp_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_n:
            best_n, best = int(m.group(1)), os.path.join(exp_dir, name)
    return best
