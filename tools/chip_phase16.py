"""Run chip_smoke.py's phase 16 (the generic per-utterance lattice route) on
one card with only the phases it builds on.

    python3 tools/chip_phase16.py

Builds the kernels and the native decoder, then runs chip_smoke's phase 3
(the flagship CE run, whose checkpoint phase 9 and phase 16(d) start from)
and phase 9 (the SE corpus, configs and host-decoder runs, whose first
decoded batch and decoders phase 16 takes), then phase 16. Any failure exits
non-zero, as chip_smoke does.
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
    root = os.path.join(c.HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    exp, _cfg_yaml, _data_yaml, _ = c.main_path(dev, root)
    ce_ckpt = os.path.join(exp, "model.0.npz")
    _launches, first, se_cfg, se_data = c.se_path(dev, root, ce_ckpt)
    print(f"phases 3 and 9 in {time.perf_counter() - t0:.1f} s", flush=True)
    c.generic_lattice_phase(dev, root, first, se_cfg, se_data, ce_ckpt)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
