"""The CUDA headers' arithmetic (csrc/field.cuh, fp2.cuh, rcb.cuh), compiled
for the host with the system's C++ compiler, against the plain PyTorch
versions of the kernels (ops/kernels.py ``*_plain``), bit for bit.

On the card the carry-chain steps of field.cuh are PTX instructions on the
carry flag; compiled for the host each step is its definition in C++ over
a flag variable (field.cuh, namespace ``cc``).  So this runs the same
sequence of steps (the Montgomery product's even/odd rounds, the chained
add, subtract and conditional subtract) and the same point formulas, term
for term, that the kernels run: what the card adds is the instruction
selection.  Inputs: seeded random words below p, with 0, 1 and p - 1 among
them; tolerance: exact."""

import ctypes
import random
import shutil
import subprocess

import pytest
import torch

from octopuszk_tpu_torch.curves import bn254
from octopuszk_tpu_torch.fields import spec as tspec
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils.bigint import ints_to_words

torch.set_num_threads(1)

N = 64

HARNESS = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__
#include "rcb.cuh"

template <class M> using Op2 = Fp<M> (*)(const Fp<M>&, const Fp<M>&);

template <class M>
static void binary(int op, const uint32_t* a, const uint32_t* b,
                   uint32_t* out, long n) {
  for (long i = 0; i < n; i++) {
    const Fp<M> x = fp_load<M>(a, n, i), y = fp_load<M>(b, n, i);
    Fp<M> r;
    switch (op) {
      case 0: r = mul(x, y); break;
      case 1: r = add(x, y); break;
      case 2: r = sub(x, y); break;
      default: r = neg(x); break;
    }
    fp_store<M>(out, n, i, r);
  }
}

// op: 0 mul, 1 add, 2 sub, 3 neg (of a); field 0 = Fr, 1 = Fq
extern "C" void field_op(int field, int op, const uint32_t* a,
                         const uint32_t* b, uint32_t* out, long n) {
  if (field == 0) binary<FrMod>(op, a, b, out, n);
  else binary<FqMod>(op, a, b, out, n);
}

static void load(G1Coord& c, uint32_t* const* p, int ci, long n, long i) {
  c = fp_load<FqMod>(p[ci], n, i);
}
static void load(G2Coord& c, uint32_t* const* p, int ci, long n, long i) {
  c.c0 = fp_load<FqMod>(p[2 * ci], n, i);
  c.c1 = fp_load<FqMod>(p[2 * ci + 1], n, i);
}
static void store(const G1Coord& c, uint32_t* const* p, int ci, long n,
                  long i) {
  fp_store<FqMod>(p[ci], n, i, c);
}
static void store(const G2Coord& c, uint32_t* const* p, int ci, long n,
                  long i) {
  fp_store<FqMod>(p[2 * ci], n, i, c.c0);
  fp_store<FqMod>(p[2 * ci + 1], n, i, c.c1);
}

// op: 0 add (p + q), 1 double (p), 2 mixed add (p + (q.x, q.y)); the
// components of each point: 3 (G1) or 6 (G2) word-major [8, n] arrays
template <class C>
static void points(int op, uint32_t* const* p, uint32_t* const* q,
                   uint32_t* const* out, long n) {
  for (long i = 0; i < n; i++) {
    Pt<C> a, b, r;
    load(a.x, p, 0, n, i); load(a.y, p, 1, n, i); load(a.z, p, 2, n, i);
    load(b.x, q, 0, n, i); load(b.y, q, 1, n, i); load(b.z, q, 2, n, i);
    if (op == 0) r = pt_add(a, b);
    else if (op == 1) r = pt_double(a);
    else r = pt_mixed_add(a, b.x, b.y);
    store(r.x, out, 0, n, i); store(r.y, out, 1, n, i);
    store(r.z, out, 2, n, i);
  }
}

extern "C" void point_op(int group, int op, uint32_t* const* p,
                         uint32_t* const* q, uint32_t* const* out, long n) {
  if (group == 1) points<G1Coord>(op, p, q, out, n);
  else points<G2Coord>(op, p, q, out, n);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "constants.cuh").write_text(kernels.constants_header())
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(kernels.CSRC), "-I", str(d),
                    str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _words(vals):
    return torch.from_numpy(ints_to_words(vals).copy())


def _field_values(p, seed):
    rng = random.Random(seed)
    vals = [0, 1, p - 1, p - 2, (1 << 255) % p] + [
        rng.randrange(p) for _ in range(N - 5)]
    rng.shuffle(vals)
    return vals


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_arithmetic(host_lib, field):
    spec = {"fr": tspec.FR, "fq": tspec.FQ}[field]
    a = _words(_field_values(spec.p, 1))
    b = _words(_field_values(spec.p, 2))
    b[:, :5] = a[:, :5]                          # equal operands
    from octopuszk_tpu_torch.fields import fp
    want = {0: kernels.mont_mul_plain(spec, a, b), 1: fp.add(spec, a, b),
            2: fp.sub(spec, a, b), 3: fp.neg(spec, a)}
    for op, w in want.items():
        out = torch.empty_like(a)
        host_lib.field_op(int(field == "fq"), op, _ptr(a), _ptr(b), _ptr(out),
                          ctypes.c_long(N))
        assert torch.equal(out, w), (field, op)


def _flat(p):
    out = []
    for c in p:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


@pytest.mark.parametrize("gname", ["G1", "G2"])
def test_point_formulas(host_lib, gname):
    """Full add, double and mixed add (the scans' step, in the order of
    rcb.cuh) on points of the curve with the identity, equal and inverse
    pairs among them, and on random field elements off the curve (the
    formulas are polynomials)."""
    from octopuszk_tpu_torch.curves import group_ops
    g = {"G1": bn254.G1, "G2": bn254.G2}[gname]
    cd = g.coord_dim
    rng = random.Random(3)
    pts = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))
           for _ in range(N)]
    qs = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))
          for _ in range(N)]
    pts[0] = None
    qs[1] = pts[1]
    qs[2] = g.host.neg(pts[2])
    on_curve = (g.points_to_device(pts, "cpu"), g.points_to_device(qs, "cpu"))
    off = tuple(group_ops.rebuild_coords(
        [_words([rng.randrange(tspec.FQ.p) for _ in range(N)])
         for _ in range(3 * cd)], cd) for _ in range(2))
    ops = kernels.plain_ops(gname)
    for p, q in (on_curve, off):
        x2, y2 = q[0], q[1]
        want = {0: kernels.add_points_plain(gname, p, q),
                1: kernels.double_points_plain(gname, p),
                2: group_ops.mixed_add(ops, p, (x2, y2))}
        fp_, fq_ = _flat(p), _flat(q)
        for op, w in want.items():
            outs = [torch.empty_like(t) for t in fp_]
            host_lib.point_op(cd, op, _ptrs(fp_), _ptrs(fq_), _ptrs(outs),
                              ctypes.c_long(N))
            for got, ref in zip(outs, _flat(w)):
                assert torch.equal(got, ref), (gname, op)
