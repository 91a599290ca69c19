"""Application R1CS constructions: matmul, linear regression, covariance.

Port of ``octopuszk_tpu/relations/apps.py``: the same numpy index patterns
and the same ``random.Random(seed)`` draws, so a seed gives the same R1CS
and assignment as the reference.  Each circuit verifies a matrix product
over public matrices (public inputs, product auxiliaries, sum constraints),
built as COO arrays without a per-constraint python loop.  The matrices
are made on ``device`` (None = the card, as ``make_sparse``).
"""

from __future__ import annotations

import random

import numpy as np

from octopuszk_tpu_torch.fields.spec import FieldSpec, FR
from octopuszk_tpu_torch.relations.r1cs import R1CS, make_sparse


def _build(spec, mats, n, num_inputs, num_vars, device):
    (ra, ca, va), (rb, cb, vb), (rc, cc, vc) = mats
    return R1CS(
        a=make_sparse(spec, ra, ca, va, n, num_vars, device),
        b=make_sparse(spec, rb, cb, vb, n, num_vars, device),
        c=make_sparse(spec, rc, cc, vc, n, num_vars, device),
        num_constraints=n,
        num_inputs=num_inputs,
        num_variables=num_vars)


def _ones(a):
    return np.ones(len(a), dtype=np.int64)


def matmul_construct(n1: int, n2: int, n3: int, seed: int = 0,
                     spec: FieldSpec = FR, device=None):
    """R1CS verifying C = A @ B for public A (n1 x n2), B (n2 x n3),
    C (n1 x n3); auxiliaries are the n1*n3*n2 products Z.

    Returns (r1cs, primary, auxiliary) host-int assignments.
    Reference: R1CSConstruction.matmulConstruct (…java:509-780) and its
    scalable twin matmulParConstruct (…java:1414+).
    """
    p = spec.p
    rng = random.Random(seed)
    a_vals = [[rng.randrange(p) for _ in range(n2)] for _ in range(n1)]
    b_vals = [[rng.randrange(p) for _ in range(n3)] for _ in range(n2)]
    c_vals = [[sum(a_vals[r][j] * b_vals[j][c] for j in range(n2)) % p
               for c in range(n3)] for r in range(n1)]

    # variable layout: [one | A | B | C | Z]
    a0 = 1
    b0 = a0 + n1 * n2
    c0 = b0 + n2 * n3
    z0 = c0 + n1 * n3
    num_inputs = z0
    num_vars = z0 + n1 * n3 * n2

    # constraints per output cell rc = r*n3 + c: n2 product rows then one
    # sum row; constraint index = rc*(n2+1) + j  (sum row at j = n2)
    rc = np.arange(n1 * n3, dtype=np.int64)
    j = np.arange(n2, dtype=np.int64)
    rcj_row = (rc[:, None] * (n2 + 1) + j[None, :]).ravel()   # product rows
    r_of = rc // n3
    c_of = rc % n3
    a_col = (a0 + r_of[:, None] * n2 + j[None, :]).ravel()    # A[r,j]
    b_col = (b0 + j[None, :] * n3 + c_of[:, None]).ravel()    # B[j,c]
    z_col = (z0 + rc[:, None] * n2 + j[None, :]).ravel()      # Z[r,c,j]
    sum_row = rc * (n2 + 1) + n2

    rows_a = np.concatenate([rcj_row, np.repeat(sum_row, n2)])
    cols_a = np.concatenate([a_col, z_col])
    rows_b = np.concatenate([rcj_row, sum_row])
    cols_b = np.concatenate([b_col, np.zeros(len(rc), np.int64)])
    rows_c = np.concatenate([rcj_row, sum_row])
    cols_c = np.concatenate([z_col, c0 + rc])

    n = n1 * n3 * (n2 + 1)
    r1cs = _build(spec, ((rows_a, cols_a, _ones(rows_a)),
                         (rows_b, cols_b, _ones(rows_b)),
                         (rows_c, cols_c, _ones(rows_c))),
                  n, num_inputs, num_vars, device)

    assignment = [1]
    assignment += [a_vals[r][j] for r in range(n1) for j in range(n2)]
    assignment += [b_vals[j][c] for j in range(n2) for c in range(n3)]
    assignment += [c_vals[r][c] for r in range(n1) for c in range(n3)]
    assignment += [a_vals[r][j] * b_vals[j][c] % p
                   for r in range(n1) for c in range(n3) for j in range(n2)]
    return r1cs, assignment[:num_inputs], assignment[num_inputs:]


def lr_construct(n: int, d: int, seed: int = 0, spec: FieldSpec = FR,
                 device=None):
    """Linear-regression check: public X (n x d), w (d), y (n), rss;
    verifies yhat = X @ w and rss = sum (yhat_i - y_i)^2.

    Reference: R1CSConstruction LR application (…java:1693+).
    """
    p = spec.p
    rng = random.Random(seed)
    x_vals = [[rng.randrange(p) for _ in range(d)] for _ in range(n)]
    w_vals = [rng.randrange(p) for _ in range(d)]
    y_vals = [rng.randrange(p) for _ in range(n)]
    yhat = [sum(x_vals[i][j] * w_vals[j] for j in range(d)) % p
            for i in range(n)]
    resid = [(yh - y) % p for yh, y in zip(yhat, y_vals)]
    rss = sum(r * r for r in resid) % p

    # variables: [one | X | w | y | rss | Z products | yhat | R^2 squares]
    x0 = 1
    w0 = x0 + n * d
    y0 = w0 + d
    rss_i = y0 + n
    z0 = rss_i + 1
    yh0 = z0 + n * d
    sq0 = yh0 + n
    num_inputs = z0
    num_vars = sq0 + n

    # per row i: d product rows, one sum row, one residual-square row;
    # constraint index = i*(d+2) + {j | d | d+1}; final global sum row last
    i = np.arange(n, dtype=np.int64)
    j = np.arange(d, dtype=np.int64)
    prod_row = (i[:, None] * (d + 2) + j[None, :]).ravel()
    x_col = (x0 + i[:, None] * d + j[None, :]).ravel()
    w_col = np.tile(w0 + j, n)
    z_col = (z0 + i[:, None] * d + j[None, :]).ravel()
    sum_row = i * (d + 2) + d
    sq_row = i * (d + 2) + d + 1
    last = n * (d + 2)

    ones_n = np.ones(n, np.int64)
    rows_a = np.concatenate([prod_row, np.repeat(sum_row, d),
                             sq_row, sq_row, np.full(n, last)])
    cols_a = np.concatenate([x_col, z_col, yh0 + i, y0 + i, sq0 + i])
    vals_a = np.concatenate([_ones(prod_row), _ones(z_col),
                             ones_n, -ones_n, ones_n])
    rows_b = np.concatenate([prod_row, sum_row, sq_row, sq_row, [last]])
    cols_b = np.concatenate([w_col, np.zeros(n, np.int64),
                             yh0 + i, y0 + i, [0]])
    vals_b = np.concatenate([_ones(prod_row), ones_n,
                             ones_n, -ones_n, [1]])
    rows_c = np.concatenate([prod_row, sum_row, sq_row, [last]])
    cols_c = np.concatenate([z_col, yh0 + i, sq0 + i, [rss_i]])
    vals_c = _ones(rows_c)

    nc = n * (d + 2) + 1
    r1cs = _build(spec, ((rows_a, cols_a, vals_a),
                         (rows_b, cols_b, vals_b),
                         (rows_c, cols_c, vals_c)),
                  nc, num_inputs, num_vars, device)

    assignment = [1]
    assignment += [x_vals[i][j] for i in range(n) for j in range(d)]
    assignment += w_vals + y_vals + [rss]
    assignment += [x_vals[i][j] * w_vals[j] % p
                   for i in range(n) for j in range(d)]
    assignment += yhat
    assignment += [r * r % p for r in resid]
    return r1cs, assignment[:num_inputs], assignment[num_inputs:]


def gaussian_construct(n: int, d: int, seed: int = 0,
                       spec: FieldSpec = FR, device=None):
    """Covariance check: public X (n x d) and S (d x d); verifies
    S = X^T @ X (the Gaussian-fit sufficient statistic).

    Reference: R1CSConstruction gaussian application (…java:2204+).
    """
    p = spec.p
    rng = random.Random(seed)
    x_vals = [[rng.randrange(p) for _ in range(d)] for _ in range(n)]
    s_vals = [[sum(x_vals[k][i] * x_vals[k][j] for k in range(n)) % p
               for j in range(d)] for i in range(d)]

    # variables: [one | X | S | Z products]
    x0 = 1
    s0 = x0 + n * d
    z0 = s0 + d * d
    num_inputs = z0
    num_vars = z0 + d * d * n

    # per output cell ij = i*d + j: n product rows + 1 sum row
    ij = np.arange(d * d, dtype=np.int64)
    k = np.arange(n, dtype=np.int64)
    i_of = ij // d
    j_of = ij % d
    prod_row = (ij[:, None] * (n + 1) + k[None, :]).ravel()
    xi_col = (x0 + k[None, :] * d + i_of[:, None]).ravel()    # X[k,i]
    xj_col = (x0 + k[None, :] * d + j_of[:, None]).ravel()    # X[k,j]
    z_col = (z0 + ij[:, None] * n + k[None, :]).ravel()       # Z[i,j,k]
    sum_row = ij * (n + 1) + n

    rows_a = np.concatenate([prod_row, np.repeat(sum_row, n)])
    cols_a = np.concatenate([xi_col, z_col])
    rows_b = np.concatenate([prod_row, sum_row])
    cols_b = np.concatenate([xj_col, np.zeros(d * d, np.int64)])
    rows_c = np.concatenate([prod_row, sum_row])
    cols_c = np.concatenate([z_col, s0 + ij])

    nc = d * d * (n + 1)
    r1cs = _build(spec, ((rows_a, cols_a, _ones(rows_a)),
                         (rows_b, cols_b, _ones(rows_b)),
                         (rows_c, cols_c, _ones(rows_c))),
                  nc, num_inputs, num_vars, device)

    assignment = [1]
    assignment += [x_vals[k][i] for k in range(n) for i in range(d)]
    assignment += [s_vals[i][j] for i in range(d) for j in range(d)]
    assignment += [x_vals[k][i] * x_vals[k][j] % p
                   for i in range(d) for j in range(d) for k in range(n)]
    return r1cs, assignment[:num_inputs], assignment[num_inputs:]
