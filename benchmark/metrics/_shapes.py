"""Work of the acoustic model, counted from its shapes (shared by the
readers of this folder)."""

from __future__ import annotations


def stack_dims(model: dict, input_dim: int):
    """[(input width, hidden, projection or 0)] for each direction of each
    layer of the recurrent stack, and the stack's output width."""
    hid, proj = model["hidden_size"], model.get("proj_size", 0)
    n_dir = 2 if model["bidirectional"] else 1
    out = (proj or hid) * n_dir
    dims = []
    for layer in range(model["num_layers"]):
        d_in = input_dim if layer == 0 else out
        dims += [(d_in, hid, proj)] * n_dir
    return dims, out


def stack_flops(model: dict, input_dim: int, frames: float) -> float:
    """Multiply-add FLOPs (2 a multiply-add) of the stack's forward and
    backward over ``frames`` frames: each product once forward and twice
    backward (data and weight gradients), except the first layer's data
    gradient, which nothing needs."""
    dims, _ = stack_dims(model, input_dim)
    total = 0.0
    for layer_idx, (d_in, hid, proj) in enumerate(dims):
        rec = proj or hid
        x_prod = d_in * 4 * hid
        r_prod = rec * 4 * hid + (hid * proj if proj else 0)
        first = layer_idx < (2 if model["bidirectional"] else 1)
        total += 3 * r_prod + (2 if first else 3) * x_prod
    return 2.0 * total * frames


def stack_bytes(model: dict, input_dim: int, frames: float, steps: int) -> float:
    """Least bytes the stack moves: each direction's input read and output
    written forward, read and written again backward, and its bf16 weights
    read once a pass, over ``steps`` steps."""
    dims, _ = stack_dims(model, input_dim)
    total = 0.0
    for d_in, hid, proj in dims:
        rec = proj or hid
        total += 2 * 4 * (d_in + rec) * frames
        total += 2 * 2 * (d_in * 4 * hid + rec * 4 * hid + hid * proj) * steps
    return total


def model_forward_flops(model: dict, input_dim: int) -> float:
    """FLOPs of one frame's forward through the stack and the output layer."""
    dims, out = stack_dims(model, input_dim)
    macs = sum(d_in * 4 * hid + (proj or hid) * 4 * hid + hid * proj
               for d_in, hid, proj in dims)
    return 2.0 * (macs + out * model["output_size"])
