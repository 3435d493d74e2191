"""Run chip_smoke.py's phase 14 on one card with only the phases it builds on.

    python3 tools/chip_phase14.py

Builds the kernels and the native decoder, then runs chip_smoke's phase 3
(the flagship CE run and its checkpoint), phase 5's step timing (the
flagship beside which phase 14 prints the backbones), phase 9 (the SE
corpus and checkpoints) and phase 12 (the decode graph, prior and host
hypotheses; without its forward split and lattice-flag run), then phase 14.
Any failure exits non-zero, as chip_smoke does. Takes about 7 minutes on an
H100 where the whole script takes twice that.
"""

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from pykaldi2_tpu_torch import device as D  # noqa: E402
from pykaldi2_tpu_torch.decode.decoder import build_native  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    dev = D.resolve_device("cuda")
    build_native(True)
    D.build_all(force=True)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    c.forward_split = lambda *a, **k: None
    c.decode_lattice_run = lambda *a, **k: None
    root = os.path.join(c.HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    exp, cfg_yaml, data_yaml, _ = c.main_path(dev, root)
    base = c.step_timing(dev, cfg_yaml, data_yaml)
    _launches, _first, se_cfg, se_data = c.se_path(dev, root, os.path.join(exp, "model.0.npz"))
    se_ckpt = os.path.join(root, "se_mmi", "model.0.npz")
    dec = c.decode_phase(dev, root, se_cfg, se_data, se_ckpt)
    print(f"phases 3, 5, 9, 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    c.device_search_phase(dev, root, os.path.join(exp, "model.0.npz"), se_cfg, se_data,
                          se_ckpt, dec, data_yaml, base)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
