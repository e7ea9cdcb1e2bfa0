"""Independent float64 probability-ratio-domain BP oracle for tests.

A direct, slow re-expression of the reference decoder's update order and
decision semantics (``LDPC_dec/ldpc/dec.cpp:583-694``) used to validate the
batched decoder's hard decisions and iteration counts. Works on the LR domain
(pr = p0/p1 = exp(LLR)) with forward/backward exclusive products, the
``pr <= 1`` decision, NaN -> 1, and syndrome-check-before-iterate, exactly
like the reference.
"""

import numpy as np


def oracle_bp_decode(H_rows, n_vars, llr, max_iter=200):
    """H_rows: list of column-index arrays per check; llr: [N] float.
    Returns (bits uint8 [N], n_iters, success)."""
    lratio = np.exp(np.asarray(llr, dtype=np.float64))
    M = len(H_rows)
    cols = [np.asarray(r) for r in H_rows]
    col_checks = [[] for _ in range(n_vars)]  # (check, slot) per variable, row order
    for i, r in enumerate(cols):
        for k, j in enumerate(r):
            col_checks[j].append((i, k))

    pr_edge = [lratio[r].copy() for r in cols]       # e->pr per check row
    lr_edge = [np.ones(len(r)) for r in cols]        # e->lr per check row
    dblk = (lratio < 1).astype(np.uint8)

    def syndrome_ok():
        return all(int(dblk[r].sum()) % 2 == 0 for r in cols)

    for n in range(max_iter + 1):
        ok = syndrome_ok()
        if ok or n == max_iter:
            return dblk.copy(), n, ok
        # check pass (dec.cpp:646-662)
        for i in range(M):
            pr = pr_edge[i]
            dl = 1.0
            tmp = np.empty_like(pr)
            for k in range(len(pr)):
                tmp[k] = dl
                dl *= 1 - 2 / (1 + pr[k])
            dl = 1.0
            for k in range(len(pr) - 1, -1, -1):
                t = tmp[k] * dl
                tmp[k] = (1 + t) / (1 - t)
                dl *= 1 - 2 / (1 + pr[k])
            lr_edge[i] = tmp
        # variable pass (dec.cpp:667-693)
        for j in range(n_vars):
            pr = lratio[j]
            for (i, k) in col_checks[j]:
                pr_edge[i][k] = pr
                pr *= lr_edge[i][k]
            if np.isnan(pr):
                pr = 1.0
            dblk[j] = 1 if pr <= 1 else 0
            pr = 1.0
            for (i, k) in reversed(col_checks[j]):
                pr_edge[i][k] *= pr
                if np.isnan(pr_edge[i][k]):
                    pr_edge[i][k] = 1.0
                pr *= lr_edge[i][k]
    return dblk.copy(), max_iter, syndrome_ok()
