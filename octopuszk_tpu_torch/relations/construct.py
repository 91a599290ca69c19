"""Synthetic R1CS workload generator: a Fibonacci-style chain of
alternating ``a + b = c`` / ``a * b = c`` constraints closed by one dense
constraint ``(sum of all chain variables)^2 = last variable`` (the dense
final constraint also exercises the hierarchical segment sum).  The same
seed gives the same circuit and assignment as the JAX package's
``serial_construct``."""

from __future__ import annotations

import random

import numpy as np

from octopuszk_tpu_torch.fields.spec import FieldSpec, FR
from octopuszk_tpu_torch.relations.r1cs import R1CS, make_sparse


def serial_construct(num_constraints: int, num_inputs: int,
                     seed: int = 0, spec: FieldSpec = FR, device=None):
    """Build (r1cs, primary, auxiliary) with host-int assignments.

    primary = full_assignment[:num_inputs] (index 0 is the constant one),
    auxiliary = the rest."""
    assert num_inputs <= num_constraints + 1
    p = spec.p
    rng = random.Random(seed)
    num_aux = 3 + num_constraints - num_inputs
    num_vars = num_inputs + num_aux

    a = rng.randrange(p)
    b = rng.randrange(p)
    assignment = [1, a, b]
    res = (a + b) % p
    for i in range(num_constraints - 1):
        tmp = a * b % p if i % 2 != 0 else (a + b) % p
        a, b = b, tmp
        assignment.append(tmp)
        res = (res + tmp) % p
    # res = sum_{i=1}^{numVars-2} z_i = a0 + b0 + all chain values
    assignment.append(res * res % p)

    # matrices as vectorized index patterns (the chain structure):
    #   even i: (z_{i+1} + z_{i+2}) * 1       = z_{i+3}
    #   odd  i:  z_{i+1} * z_{i+2}            = z_{i+3}
    #   last:   (sum z_1..z_{nv-2})^2         = z_{nv-1}
    i = np.arange(num_constraints - 1, dtype=np.int64)
    even = i % 2 == 0
    last = num_constraints - 1
    dense = np.arange(1, num_vars - 1, dtype=np.int64)
    lastrow = np.full(dense.shape, last, dtype=np.int64)

    rows_a = np.concatenate([i, i[even], lastrow])
    cols_a = np.concatenate([i + 1, i[even] + 2, dense])
    rows_b = np.concatenate([i, lastrow])
    cols_b = np.concatenate([np.where(even, 0, i + 2), dense])
    rows_c = np.concatenate([i, [last]])
    cols_c = np.concatenate([i + 3, [num_vars - 1]])

    def mat(rows, cols):
        return make_sparse(spec, rows, cols, np.ones(len(rows), np.int64),
                           num_constraints, num_vars, device)

    r1cs = R1CS(a=mat(rows_a, cols_a), b=mat(rows_b, cols_b),
                c=mat(rows_c, cols_c), num_constraints=num_constraints,
                num_inputs=num_inputs, num_variables=num_vars)
    assert len(assignment) == num_vars
    return r1cs, assignment[:num_inputs], assignment[num_inputs:]
