#!/usr/bin/env python3
"""How often the JAX package's own engines agree on a dense volume.

    JAX_PLATFORMS=cpu python3 scripts/jax_engine_agreement.py [N]

Skeletonizes bench.py's dense generator at N^3 (default 160: 65 labels of
the 512^3 volume's size) with kimimaro_tpu twice, once through the global
lock-step engine (KIMIMARO_TPU_GLOBAL_ENGINE=1) and once through the crop
engine (=0), and prints how many labels' skeletons differ. The two engines
round the PDRF differently, so the count is the
reference's own, not the port's. Runs on the CPU in about 10 minutes.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the volume generator and TEASAR)
import kimimaro_tpu  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 160
    vol = chip_smoke.dense_volume(n)
    out = {}
    for flag in ("1", "0"):
        os.environ["KIMIMARO_TPU_GLOBAL_ENGINE"] = flag
        t0 = time.perf_counter()
        out[flag] = kimimaro_tpu.skeletonize(
            vol, teasar_params=chip_smoke.TEASAR, anisotropy=chip_smoke.ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True)
        print(f"global engine {flag}: {len(out[flag])} skeletons in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    a, b = out["1"], out["0"]
    differ = sorted(k for k in a if k not in b or not np.array_equal(
        np.sort(a[k].vertices, axis=0), np.sort(b[k].vertices, axis=0)))
    print(f"{n}^3, {len(np.unique(vol[vol > 0]))} labels: global engine and crop "
          f"engine differ on {len(differ)} of {len(a)}: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
