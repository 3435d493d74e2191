"""npz checkpoints with atomic writes and resume, readable by either package.

Port of pykaldi2_tpu/utils/checkpoint.py. Parameters are written under the
same npz keys the JAX package writes, e.g.
``['params']['nnet']['layers'][0]['fwd']['wh']``, in the same layouts, so a
params checkpoint written here loads with ``pykaldi2_tpu.utils.load_checkpoint``
and the reverse. Optimizer state uses the port's own keys
(``['torch_opt'][...]``), which the JAX loader ignores. A JAX checkpoint's
optax state (``['opt_state']``, the chain of pykaldi2_tpu/utils/lr.py:
clip → (decay) → sgd | momentum | adam → inject_hyperparams(lr_scale)) is
carried into the port's ``Optimizer`` when the file has no ``torch_opt``:
adam's ``mu``/``nu``/``count`` become ``exp_avg``/``exp_avg_sq``/``step``,
the momentum ``trace`` becomes ``momentum_buffer``, the schedule's count
``Optimizer.count`` and the injected ``lr_scale`` ``Optimizer.lr_scale``;
what the port cannot map is named in one warning, never dropped silently.
Metadata goes to a JSON sidecar (``path.json``).
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.convert import keystr, params_from_jax, params_to_jax, unflatten, walk

_PARAMS = "['params']"
_OPT = "['torch_opt']"
_JAX_OPT = "['opt_state']"
log = logging.getLogger("pykaldi2_tpu_torch")


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
    # per-process temporaries: data-parallel ranks may share one exp_dir
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if meta is not None:
        tmpm = f"{path}.{os.getpid()}.json.tmp"
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
    dev = next(model.parameters()).device
    if optimizer is not None and opt:
        tree = _nest(opt, _OPT)
        _load_opt(optimizer, {int(idx): st for idx, st in tree.get("state", {}).items()},
                  int(tree["count"]), float(tree["lr_scale"]), dev)
    elif optimizer is not None:
        jax_opt = {k: v for k, v in flat.items() if k.startswith(_JAX_OPT)}
        if jax_opt:
            dropped = opt_state_from_jax(jax_opt, model, optimizer, dev)
            if dropped:
                log.warning("%s: optimizer state not carried over from the JAX checkpoint "
                            "(%s); training resumes with a fresh optimizer state",
                            path, "; ".join(dropped))
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return meta


def _load_opt(optimizer, state: dict, count: int, lr_scale: float, dev) -> None:
    """Per-parameter base-optimizer state {index: {name: array}} → ``optimizer``
    (``step`` stays on the CPU, as torch.optim keeps it)."""
    base = optimizer.base.state_dict()
    base["state"] = {
        idx: {k: (torch.as_tensor(np.asarray(v)) if k == "step"
                  else torch.as_tensor(np.asarray(v)).to(dev))
              for k, v in st.items() if v is not None}
        for idx, st in state.items()}
    optimizer.load_state_dict({"base": base, "count": count, "lr_scale": lr_scale})


_JAX_LEAF = re.compile(r"^\['opt_state'\]((?:\[\d+\])+)\.(\w+)(.*)$")


def opt_state_from_jax(flat: dict, model: torch.nn.Module, optimizer, dev) -> list:
    """Map a JAX checkpoint's optax state (flattened npz keys
    ``['opt_state'][i][j].field[...]``) into ``optimizer``; returns what could
    not be mapped (empty when everything was carried over, and then the
    optimizer holds it all).

    The leaves are found by their field: ``mu``/``nu`` (ScaleByAdamState, its
    ``count`` beside them), ``trace`` (TraceState), ``hyperparams['lr_scale']``
    (InjectStatefulHyperparamsState, its own ``count`` unused) and the
    remaining ``count``, the schedule's. Parameters are matched by the
    convert.py key of their name."""
    fields: dict = {}
    for key, value in flat.items():
        m = _JAX_LEAF.match(key)
        if m is None:
            return [f"unrecognised leaf {key}"]
        fields.setdefault(m.group(2), {})[(m.group(1), m.group(3))] = value
    adam_at = {p for p, _ in fields.get("mu", {})}
    inject_at = {p for p, _ in fields.get("hyperparams", {})}
    sched = [v for (p, _), v in fields.get("count", {}).items()
             if p not in adam_at and p not in inject_at]
    lr_scale = [v for (_, sub), v in fields.get("hyperparams", {}).items()
                if sub == "['lr_scale']"]
    kind = optimizer.cfg.type
    moments = {"adam": ("mu", "nu"), "momentum": ("trace",), "sgd": ()}[kind]
    other = {"mu", "nu", "trace"} - set(moments)
    dropped = [f"its {f} (the port's optimizer is {kind})" for f in sorted(other & set(fields))]
    dropped += [f"no {f} for a {kind} optimizer" for f in moments if f not in fields]
    if len(sched) != 1 or len(lr_scale) != 1:
        dropped.append(f"{len(sched)} schedule counts and {len(lr_scale)} lr_scale leaves "
                       f"(expected one each)")
    if dropped:
        return dropped
    names = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}
    state: dict = {}
    for idx, (name, p) in enumerate(model.named_parameters()):
        sub = keystr(tuple(int(x) if x.isdigit() else x for x in name.split(".")))
        st = {}
        for f in moments:
            found = [v for (_, s), v in fields[f].items() if s == sub]
            if len(found) != 1 or tuple(found[0].shape) != tuple(p.shape):
                return [f"{f} of parameter {name}"]
            st[names[f]] = np.asarray(found[0], np.float32)
        if kind == "adam":
            count = [v for (pre, _), v in fields["count"].items() if pre in adam_at]
            if len(count) != 1:
                return ["adam's count"]
            st["step"] = np.asarray(count[0], np.float32)
        if st:
            state[idx] = st
    _load_opt(optimizer, state, int(sched[0]), float(lr_scale[0]), dev)
    return []


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
