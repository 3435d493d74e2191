"""Run chip_smoke.py's phase 15 (the data-parallel paths) on one card with only
the phases it builds on.

    python3 tools/chip_phase15.py

Builds the kernels and the native decoder, then runs chip_smoke's phase 3
(the flagship CE run, whose checkpoint phase 15(a) must equal), phase 9 (the
SE corpus, configs and host-decoder runs) and the MMI run of phase 14(b)
(``train_se -on_the_fly -decoder device``, whose checkpoint phase 15(d) must
equal), then phase 15. Any failure exits non-zero, as chip_smoke does.
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
    from pykaldi2_tpu_torch.bin import train_se

    t0 = time.perf_counter()
    dev = D.resolve_device("cuda")
    build_native(True)
    D.build_all(force=True)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = os.path.join(c.HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    exp, cfg_yaml, data_yaml, _ = c.main_path(dev, root)
    ce_ckpt = os.path.join(exp, "model.0.npz")
    _launches, _first, se_cfg, se_data = c.se_path(dev, root, ce_ckpt)
    se = c.DEV_SE
    rc = train_se.main(
        ["-config", se_cfg, "-data", se_data, "-exp_dir", os.path.join(root, "se_dev_mmi"),
         "-on_the_fly", "-decoder", "device", "-criterion", "mmi", "-seed_model", ce_ckpt,
         "-trans_model", os.path.join(root, "se_corpus", "final.mdl"), "-beam",
         str(se["beam"]), "-lattice_beam", str(se["lattice_beam"]), "-max_active",
         str(se["max_active"]), "-max_arcs", str(se["max_arcs"])], device=str(dev))
    if rc != 0:
        c.fail(f"phase 14(b)'s MMI run returned {rc}")
    print(f"phases 3, 9 and 14(b) MMI in {time.perf_counter() - t0:.1f} s", flush=True)
    c.parallel_phase(dev, root, exp, cfg_yaml, data_yaml, se_cfg, se_data, ce_ckpt)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
