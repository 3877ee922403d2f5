"""The rail-field pointer chase and the default relax depth.

Counterpart of kimimaro_tpu.ops.fused_trace (`RELAX_ROUNDS`, `_chase`)
without the fused on-device path loop: the host trace path (trace.py) and
the global engine (gengine.py) use these.
"""

from __future__ import annotations

import numpy as np

# Default sweep-round count of a relaxation stage. Rounds needed = number
# of "bends" in the worst geodesic; compact shapes converge in a handful,
# and callers escalate (or flag) what is still changing after it.
RELAX_ROUNDS = 6

INF = np.float32(np.inf)


def _chase(d_pad, start, max_len: int):
    """Walk the shortest-path tree from `start` to the nearest rail
    (d <= 0): at each voxel step to the 26-neighbour minimizing the rail
    distance (first-minimum tie break in lexicographic offset order).

    d_pad: the rail field (numpy) padded by one +inf voxel on every side;
    the walk runs on the host. Returns (path (L, 3) int32 with -1 padding,
    length, reached_rail). Indices clamp at the padded volume's edge like
    the JAX package's dynamic slices."""
    L = int(max_len)
    hi = np.asarray(d_pad.shape, dtype=np.int64) - 3
    path = np.full((L, 3), -1, dtype=np.int32)
    cur = np.asarray(start, dtype=np.int64).reshape(3)
    i = 0
    reached = False
    while i < L:
        path[i] = cur
        i += 1
        c = np.clip(cur + 1, 0, np.asarray(d_pad.shape) - 1)
        if d_pad[c[0], c[1], c[2]] <= 0.0:
            reached = True
            break
        o = np.clip(cur, 0, hi)
        win = d_pad[o[0]:o[0] + 3, o[1]:o[1] + 3, o[2]:o[2] + 3]
        win = win.reshape(27).copy()
        win[13] = INF
        k = int(np.argmin(win))
        cur = cur + np.array([k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1])
    return path, i, reached
