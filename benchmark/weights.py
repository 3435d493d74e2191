"""Initial weights of a recurrent acoustic model, made from the seed on the
device in one draw: U(−1/√H, 1/√H) for every tensor of the stack and
U(−1/√D, 1/√D) for the output layer (D its input width), torch's LSTM
convention. The names are the program's parameter names, so the same
tensors go to the program and, drawn again, to the reference."""

from __future__ import annotations

import math

import torch


def spec(model: dict, input_dim: int) -> list:
    """[(name, shape, bound)] in draw order."""
    hid, proj = model["hidden_size"], model.get("proj_size", 0)
    rec = proj or hid
    dirs = ("fwd", "bwd") if model["bidirectional"] else ("fwd",)
    out_dim = rec * len(dirs)
    k = 1.0 / math.sqrt(hid)
    items = []
    for layer in range(model["num_layers"]):
        d_in = input_dim if layer == 0 else out_dim
        for d in dirs:
            pre = f"nnet.layers.{layer}.{d}."
            items += [(pre + "wx", (d_in, 4 * hid), k), (pre + "wh", (rec, 4 * hid), k),
                      (pre + "b", (4 * hid,), k)]
            if proj:
                items.append((pre + "wp", (hid, proj), k))
    ko = 1.0 / math.sqrt(out_dim)
    items += [("out_w", (out_dim, model["output_size"]), ko),
              ("out_b", (model["output_size"],), ko)]
    return items


def make(items: list, seed: int, device: torch.device) -> dict:
    """{name: fp32 tensor on ``device``} from one uniform draw of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in items)
    flat = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, bound in items:
        n = math.prod(shape)
        out[name] = (flat[off:off + n].view(shape) * (2.0 * bound) - bound).clone()
        off += n
    return out


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the module's parameters, which must be exactly
    the same names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: program {sorted(set(params) - set(weights))}"
                         f", benchmark {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
