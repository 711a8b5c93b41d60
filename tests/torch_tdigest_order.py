"""The order in which the card's t-digest reduction adds, restated in numpy.

``tdigest_reduce_kernel`` (``anomod_torch/csrc/sketch.cu``) gives each
digest lane four warps.  The lane's steps of 128 slots are cut into four
contiguous ranges (warp q takes steps ``[S*q // 4, S*(q+1) // 4)`` of
``S``), lane t of a warp holding slots ``4t .. 4t + 3`` of a step;
sub-step u of a step takes slot ``4t + u`` of every lane t.  In a
sub-step, runs of equal in-range buckets over consecutive lanes sum ``(w,
wv)`` by a Hillis-Steele segmented inclusive scan (offsets 1, 2, 4, 8,
16; a lane adds the value ``d`` lanes below while that lane is in its
run), and each run's tail lane adds its sums into the warp's partial, in
lane order.  The four partials then add in warp order.  Slots with a
bucket outside ``[0, K)`` (and slots past the row's end) add nothing.
The mean is ``sum(wv) / sum(w)``, 0 where the weight is 0.

Every step is restated in f32, so the kernel's output must equal this
function's bit for bit (``tests/test_torch_cuda.py``); on the host it is
held against the plain version and the Pallas kernel
(``tests/test_torch_sketch_kernels.py``).  No JAX here: the card-only
tests import it.
"""

import numpy as np

LANES, SLOTS, WARPS = 32, 4, 4
STEP = LANES * SLOTS


def tdigest_reduce_in_kernel_order(bucket, w, wv, k: int):
    """``bucket int32[R, L]``, ``w, wv f32[R, L]`` -> ``(mean, weight)
    f32[R, K]``, added in the kernel's order."""
    bucket = np.asarray(bucket, np.int32)
    w = np.asarray(w, np.float32)
    wv = np.asarray(wv, np.float32)
    R, L = bucket.shape
    steps = -(-L // STEP)
    pad = ((0, 0), (0, steps * STEP - L))
    key = np.pad(bucket, pad, constant_values=-1)
    valid = (key >= 0) & (key < k)
    zero = np.float32(0.0)
    a = np.where(valid, np.pad(w, pad), zero)
    b = np.where(valid, np.pad(wv, pad), zero)
    # [R, steps, lane, slot]: lane t's 4 consecutive slots of each step
    key, valid, a, b = (x.reshape(R, steps, LANES, SLOTS)
                        for x in (key, valid, a, b))
    lane = np.arange(LANES)
    rows = np.arange(R)
    part_w = np.zeros((WARPS, R, k), np.float32)
    part_wv = np.zeros((WARPS, R, k), np.float32)
    for s in range(steps):
        q = next(q for q in range(WARPS) if s < steps * (q + 1) // WARPS)
        acc_w, acc_wv = part_w[q], part_wv[q]
        for u in range(SLOTS):
            kk = np.where(valid[:, s, :, u], key[:, s, :, u], -1 - lane)
            x, y = a[:, s, :, u], b[:, s, :, u]
            head = np.ones((R, LANES), bool)
            head[:, 1:] = kk[:, 1:] != kk[:, :-1]
            start = np.maximum.accumulate(np.where(head, lane, 0), axis=1)
            tail = np.ones((R, LANES), bool)
            tail[:, :-1] = head[:, 1:]
            for d in (1, 2, 4, 8, 16):
                take = lane - d >= start
                xs = np.concatenate([x[:, :d], x[:, :-d]], axis=1)
                ys = np.concatenate([y[:, :d], y[:, :-d]], axis=1)
                x = np.where(take, x + xs, x)
                y = np.where(take, y + ys, y)
            emit = tail & (kk >= 0)
            for t in range(LANES):
                m = emit[:, t]
                if m.any():
                    r, c = rows[m], kk[m, t]
                    acc_w[r, c] = acc_w[r, c] + x[m, t]
                    acc_wv[r, c] = acc_wv[r, c] + y[m, t]
    acc_w, acc_wv = part_w[0], part_wv[0]
    for q in range(1, WARPS):
        acc_w = acc_w + part_w[q]
        acc_wv = acc_wv + part_wv[q]
    pos = acc_w > 0
    mean = np.where(pos, acc_wv / np.where(pos, acc_w, np.float32(1.0)),
                    zero)
    return mean.astype(np.float32), acc_w
