// Complete projective curve arithmetic for a = 0 curves (Renes, Costello,
// Batina 2015, algorithms 7, 8, 9), templated on the coordinate field:
// Fp<M> for G1, Fp2<M> for G2, M the curve's Fq modulus (FqMod for BN254a,
// FqbMod for BN254b), whose traits give b3 = 3 b.  The identity is (0, 1,
// 0).  The formulas are those of curves/group_ops.py, term for term, so the
// projective coordinates that come out are the same words.
#pragma once
#include "fp2.cuh"

// b3 = 3 b: on G1 an addition chain (9 on BN254a, 39 on BN254b), on the G2
// twist a product by the constant 3 b / xi
template <class M>
__device__ __forceinline__ Fp<M> mul_b3(const Fp<M>& a) {
  return mul_small<M::kB3>(a);
}

template <class M>
__device__ __forceinline__ Fp2<M> mul_b3(const Fp2<M>& a) {
  Fp2<M> b3;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    b3.c0.v[k] = M::b3_c0(k);
    b3.c1.v[k] = M::b3_c1(k);
  }
  return mul(a, b3);
}

template <class M>
__device__ __forceinline__ void coord_zero(Fp<M>& c) { c = fp_zero<M>(); }
template <class M>
__device__ __forceinline__ void coord_one(Fp<M>& c) { c = fp_one<M>(); }
template <class M>
__device__ __forceinline__ void coord_zero(Fp2<M>& c) {
  c.c0 = fp_zero<M>();
  c.c1 = fp_zero<M>();
}
template <class M>
__device__ __forceinline__ void coord_one(Fp2<M>& c) {
  c.c0 = fp_one<M>();
  c.c1 = fp_zero<M>();
}

template <class C>
struct Pt {
  C x, y, z;
};

// P + Q, complete (algorithm 7): 12 products and 2 mul_b3
template <class C>
__device__ __forceinline__ Pt<C> pt_add(const Pt<C>& p, const Pt<C>& q) {
  C t0 = mul(p.x, q.x);
  C t1 = mul(p.y, q.y);
  C t2 = mul(p.z, q.z);
  C t3 = mul(add(p.x, p.y), add(q.x, q.y));
  C t4 = mul(add(p.y, p.z), add(q.y, q.z));
  C t5 = mul(add(p.x, p.z), add(q.x, q.z));
  t3 = sub(t3, add(t0, t1));
  t4 = sub(t4, add(t1, t2));
  t5 = sub(t5, add(t0, t2));
  const C three_t0 = add(dbl(t0), t0);
  const C b3t2 = mul_b3(t2);
  const C z3 = add(t1, b3t2);
  t1 = sub(t1, b3t2);
  const C y3 = mul_b3(t5);
  Pt<C> r;
  r.x = sub(mul(t3, t1), mul(t4, y3));
  r.y = add(mul(y3, three_t0), mul(t1, z3));
  r.z = add(mul(z3, t4), mul(three_t0, t3));
  return r;
}

// [2]P, complete (algorithm 9): 8 products and 1 mul_b3
template <class C>
__device__ __forceinline__ Pt<C> pt_double(const Pt<C>& p) {
  C t0 = mul(p.y, p.y);
  const C t1 = mul(p.y, p.z);
  const C tzz = mul(p.z, p.z);
  const C txy = mul(p.x, p.y);
  const C z3 = dbl(dbl(dbl(t0)));
  const C t2 = mul_b3(tzz);
  const C y3a = add(t0, t2);
  const C t2_3 = add(dbl(t2), t2);
  t0 = sub(t0, t2_3);
  Pt<C> r;
  r.x = dbl(mul(t0, txy));
  r.y = add(mul(t2, z3), mul(t0, y3a));
  r.z = mul(t1, z3);
  return r;
}

// P (projective) + Q (affine, not the identity), complete in P
// (algorithm 8): 11 products and 2 mul_b3.  The terms are those of
// group_ops.py; they are computed in the order that keeps the fewest
// coordinates alive (Z1's three products first, then X1 and Y1's, each
// output product as soon as its operands exist), which is what keeps the
// G2 scan inside its register budget.
template <class C>
__device__ __forceinline__ Pt<C> pt_mixed_add(const Pt<C>& p, const C& x2,
                                              const C& y2) {
  const C t4 = add(mul(x2, p.z), p.x);        // X1 + X2 Z1
  const C t5 = add(mul(y2, p.z), p.y);        // Y1 + Y2 Z1
  const C b3z1 = mul_b3(p.z);
  C t3 = mul(add(x2, y2), add(p.x, p.y));
  const C t0 = mul(p.x, x2);
  C t1 = mul(p.y, y2);
  t3 = sub(t3, add(t0, t1));                  // X1 Y2 + X2 Y1
  const C three_t0 = add(dbl(t0), t0);
  const C z3 = add(t1, b3z1);
  t1 = sub(t1, b3z1);
  const C y3 = mul_b3(t4);
  Pt<C> r;
  const C t3t1 = mul(t3, t1);
  const C t1z3 = mul(t1, z3);
  r.x = sub(t3t1, mul(t5, y3));
  r.y = add(mul(y3, three_t0), t1z3);
  r.z = add(mul(z3, t5), mul(three_t0, t3));
  return r;
}

// ---------------------------------------------------------------------------
// Point batches in device memory: one pointer per base-field component of
// each coordinate, G1 (X, Y, Z), G2 (X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1);
// each component word-major, word k of point i at k * stride + i.
// ---------------------------------------------------------------------------

struct PointPtrs {
  uint32_t* c[6];
};

// from the addresses the wrappers pass (3 for G1, 6 for G2); host code
inline PointPtrs make_ptrs(const unsigned long long* addrs, int count) {
  PointPtrs p;
  for (int k = 0; k < 6; k++)
    p.c[k] = k < count ? (uint32_t*)(uintptr_t)addrs[k] : nullptr;
  return p;
}

// L2: read through the L2 cache only (ld.global.cg), for words that
// another block of the same launch wrote: this SM's L1 may hold the line
// from before the write
template <bool L2, class M>
__device__ __forceinline__ Fp<M> fp_load_at(const uint32_t* base,
                                            size_t stride, size_t i) {
#if defined(__CUDA_ARCH__)
  if (L2) {
    Fp<M> r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.v[k] = __ldcg(base + k * stride + i);
    return r;
  }
#endif
  return fp_load<M>(base, stride, i);
}

template <bool L2 = false, class M>
__device__ __forceinline__ void load_coord(Fp<M>& c, const PointPtrs& p,
                                           int ci, size_t n, size_t i) {
  c = fp_load_at<L2, M>(p.c[ci], n, i);
}
template <bool L2 = false, class M>
__device__ __forceinline__ void load_coord(Fp2<M>& c, const PointPtrs& p,
                                           int ci, size_t n, size_t i) {
  c.c0 = fp_load_at<L2, M>(p.c[2 * ci], n, i);
  c.c1 = fp_load_at<L2, M>(p.c[2 * ci + 1], n, i);
}
template <class M>
__device__ __forceinline__ void store_coord(const Fp<M>& c,
                                            const PointPtrs& p, int ci,
                                            size_t n, size_t i) {
  fp_store<M>(p.c[ci], n, i, c);
}
template <class M>
__device__ __forceinline__ void store_coord(const Fp2<M>& c,
                                            const PointPtrs& p, int ci,
                                            size_t n, size_t i) {
  fp_store<M>(p.c[2 * ci], n, i, c.c0);
  fp_store<M>(p.c[2 * ci + 1], n, i, c.c1);
}

template <class C, bool L2 = false>
__device__ __forceinline__ Pt<C> load_point(const PointPtrs& p, size_t n,
                                            size_t i) {
  Pt<C> r;
  load_coord<L2>(r.x, p, 0, n, i);
  load_coord<L2>(r.y, p, 1, n, i);
  load_coord<L2>(r.z, p, 2, n, i);
  return r;
}

template <class C>
__device__ __forceinline__ void store_point(const Pt<C>& r, const PointPtrs& p,
                                            size_t n, size_t i) {
  store_coord(r.x, p, 0, n, i);
  store_coord(r.y, p, 1, n, i);
  store_coord(r.z, p, 2, n, i);
}

// a if h, else b, word by word
template <class M>
__device__ __forceinline__ Fp<M> choose(bool h, const Fp<M>& a,
                                        const Fp<M>& b) {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = h ? a.v[k] : b.v[k];
  return r;
}
template <class M>
__device__ __forceinline__ Fp2<M> choose(bool h, const Fp2<M>& a,
                                         const Fp2<M>& b) {
  return {choose(h, a.c0, b.c0), choose(h, a.c1, b.c1)};
}

// P + Q (pt_add, algorithm 7) on the two threads of a pair, h = 0 and 1,
// each running half the products of each level: thread 0 X1 X2, Y1 Y2,
// Z1 Z2, b3 t2 and the products of X3 and of Z3's first term; thread 1
// the three products of sums, b3 t5 and the products of Y3 and of Z3's
// second term.  X::other(v) is v of the pair's other thread; the products
// meet after each level.  Both threads return P + Q in pt_add's words:
// the same products and sums of the same operands in the same order.
template <class C, class X>
__device__ __forceinline__ Pt<C> pt_add_pair(const Pt<C>& p, const Pt<C>& q,
                                             bool h) {
  const C u0 = mul(choose(h, add(p.x, p.y), p.x),
                   choose(h, add(q.x, q.y), q.x));
  const C u1 = mul(choose(h, add(p.y, p.z), p.y),
                   choose(h, add(q.y, q.z), q.y));
  const C u2 = mul(choose(h, add(p.x, p.z), p.z),
                   choose(h, add(q.x, q.z), q.z));
  const C v0 = X::other(u0), v1 = X::other(u1), v2 = X::other(u2);
  const C t0 = choose(h, v0, u0), t1 = choose(h, v1, u1);
  const C t2 = choose(h, v2, u2);
  const C t3 = sub(choose(h, u0, v0), add(t0, t1));
  const C t4 = sub(choose(h, u1, v1), add(t1, t2));
  const C t5 = sub(choose(h, u2, v2), add(t0, t2));
  const C three_t0 = add(dbl(t0), t0);
  const C w = mul_b3(choose(h, t5, t2)), wx = X::other(w);
  const C b3t2 = choose(h, wx, w), y3 = choose(h, w, wx);
  const C z3 = add(t1, b3t2);
  const C t1m = sub(t1, b3t2);
  // thread 0: t3 t1, t4 y3 (X3) and z3 t4; thread 1: y3 3t0, t1 z3 (Y3)
  // and 3t0 t3
  const C m0 = mul(choose(h, y3, t3), choose(h, three_t0, t1m));
  const C m1 = mul(choose(h, t1m, t4), choose(h, z3, y3));
  const C m2 = mul(choose(h, three_t0, z3), choose(h, t3, t4));
  const C o = choose(h, add(m0, m1), sub(m0, m1));
  const C ox = X::other(o), m2x = X::other(m2);
  Pt<C> r;
  r.x = choose(h, ox, o);
  r.y = choose(h, o, ox);
  r.z = add(choose(h, m2x, m2), choose(h, m2, m2x));
  return r;
}

template <class C>
__device__ __forceinline__ Pt<C> pt_identity() {
  Pt<C> r;
  coord_zero(r.x);
  coord_one(r.y);
  coord_zero(r.z);
  return r;
}

// pt_add(P, (0, 1, 0)): with X2 = Z2 = 0 and Y2 = 1 its terms are t0 = t2
// = t5 = 0, t1 = Y1, t3 = X1, t4 = Z1, so the sum is (X1 Y1, Y1^2, Y1 Z1),
// 3 products of 12.  Every field operation returns the canonical residue,
// so these are pt_add's words.  On a pair (T = 2) thread h makes what
// store_part<2> stores from it: X and Z (h = 0), Y (h = 1).
template <int T, class C>
__device__ __forceinline__ Pt<C> pt_add_identity(const Pt<C>& p, bool h) {
  Pt<C> r;
  if (T == 1) {
    r.x = mul(p.x, p.y);
    r.y = mul(p.y, p.y);
  } else {
    r.x = mul(choose(h, p.y, p.x), p.y);
    r.y = r.x;
  }
  r.z = mul(p.y, p.z);
  return r;
}

#if defined(__CUDACC__)
// X of pt_add_pair on the card: the value of the other thread of a pair
// (lanes 2k, 2k + 1 of a warp; every lane of the warp calls it)
struct ShflPair {
  template <class M>
  static __device__ __forceinline__ Fp<M> other(const Fp<M>& a) {
    Fp<M> r;
#pragma unroll
    for (int k = 0; k < 8; k++)
      r.v[k] = __shfl_xor_sync(0xffffffffu, a.v[k], 1);
    return r;
  }
  template <class M>
  static __device__ __forceinline__ Fp2<M> other(const Fp2<M>& a) {
    return {other(a.c0), other(a.c1)};
  }
};
#endif

// Kernel (d) add_points on the two threads of a pair: thread t (h = t & 1)
// runs its half of P + Q for point t / 2 of the batch of n; a thread past
// the end repeats the last point and stores nothing.  Both threads load
// both points (the second read of a word hits the cache); thread 0
// stores X and Z, thread 1 Y.
template <class C, class X>
__device__ __forceinline__ void add_point_pair(const PointPtrs& p,
                                               const PointPtrs& q,
                                               const PointPtrs& out,
                                               size_t n, size_t t) {
  const bool h = t & 1, live = (t >> 1) < n;
  const size_t i = live ? t >> 1 : n - 1;
  const Pt<C> r = pt_add_pair<C, X>(load_point<C>(p, n, i),
                                    load_point<C>(q, n, i), h);
  if (!live) return;
  if (h) {
    store_coord(r.y, out, 1, n, i);
  } else {
    store_coord(r.x, out, 0, n, i);
    store_coord(r.z, out, 2, n, i);
  }
}

// ---------------------------------------------------------------------------
// The loops of ops/msm.py and curves/group_ops.py that run as one launch
// each.  Every function keeps the adds of the loop it stands for, with the
// same operands in the same order, the adds with the identity included
// (the complete add of P and the identity returns a multiple of P's
// coordinates, not P's words), so the projective words that come out are
// the plain versions'.
// ---------------------------------------------------------------------------

// The row loop of msm._scan_sum for one lane, on the two threads of a
// pair (h = 0, 1; X as pt_add_pair): from the identity, add the lane's
// ``rows`` positions lane * rows + r of the batch row that starts at
// ``at``, in order; a position at or past n is the identity padding.
// Both threads return the sum.
template <class C, class X>
__device__ __forceinline__ Pt<C> lane_row_sum_pair(const PointPtrs& p,
                                                   size_t stride, size_t at,
                                                   size_t n, size_t lane,
                                                   size_t rows, bool h) {
  Pt<C> acc = pt_identity<C>();
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = lane * rows + r;
    const bool in = pos < n;
    Pt<C> q = load_point<C>(p, stride, at + (in ? pos : 0));
    if (!in) q = pt_identity<C>();
    acc = pt_add_pair<C, X>(acc, q, h);
  }
  return acc;
}

// The items of one level that a thread takes: first, first + step, ...
// below end.
struct ItemRange {
  size_t first, step, end;
};

__device__ __forceinline__ int ceil_log2(size_t n) {
  int l = 0;
  while (((size_t)1 << l) < n) l++;
  return l;
}

// group_ops.tree_reduce over each row of the [8, batch, n] batch ``in``:
// element 0 of its Hillis-Steele suffix fold, which is the pairwise tree
// whose node j at level l (j a multiple of 2^(l+1)) is node j plus node j
// + 2^l of level l - 1 (the leaves at level -1), or plus the identity
// where j + 2^l >= n: n - 1 adds and the identity adds, in that operand
// order (kernels.tree_sum_plain).  The 2^K nodes of a level that start at
// a multiple of 2^K times their spacing make one node K levels up and
// need nothing else, so the L = ceil(log2 n) levels run in tiers of K:
// tier t reduces groups of up to 2^K nodes spaced u = 2^(K t) apart (tier
// 0: the leaves) on the 2^K threads of one block, each add on a pair
// (pt_add_pair, X its exchange), the nodes in shared memory between the
// block's barriers.  A group's root goes to ``scratch`` at its position
// (to ``out`` [8, batch] from the last tier); the block that brings a
// parent group's count of arrived groups to its number of groups goes on
// with that group at tier t + 1, the others end.  Rows shorter than 2^K
// make one subtree of 2^L leaves each, 2^K / 2^L rows a block; n = 1 is a
// copy, one row a thread.

// the tier of tree_sum_kernel (bucket_kernels.cu): blocks of 2^kTreeLog
// threads, subtrees of as many leaves (chosen by measurement, PERF.md)
constexpr int kTreeLog = 8;

// the blocks of a launch, and how rows map on them
struct TreeShape {
  int levels;        // L
  int first;         // levels of tier 0: min(K, L)
  size_t groups;     // tier-0 groups a row
  size_t per_block;  // tier-0 groups a block
  size_t blocks;
};

template <int K>
__host__ __device__ inline TreeShape tree_shape(size_t batch, size_t n) {
  TreeShape s;
  s.levels = 0;
  while (((size_t)1 << s.levels) < n) s.levels++;
  s.first = s.levels < K ? s.levels : K;
  s.groups = (n + ((size_t)1 << s.first) - 1) >> s.first;
  s.per_block = (size_t)1 << (K - s.first);
  s.blocks = (batch * s.groups + s.per_block - 1) / s.per_block;
  return s;
}

// Level m of a tier on the 2^levels threads of a group (lt: this thread's
// index among them; pair q = lt / 2, half h = lt & 1).  Input i of the
// tier is node base + i u of the row at ``at`` in ``src``, absent at or
// past n.  Pair q < 2^(levels - 1 - m) makes node i = q 2^(m+1) from
// nodes i and i + 2^m of level m - 1 (the identity where i + 2^m is
// absent): from ``src`` at m = 0, else from slots i / 2 and (i + 2^m) / 2
// of ``slots`` (``nslots`` slots, the group's from ``slot0``), and leaves
// it in slot i / 2 (the last level's, the root, in slot 0).  A pair whose
// node is absent adds slot 0 to the identity and keeps nothing; a warp
// none of whose pairs has a node skips the level (the others run whole:
// they shuffle).  ``src`` is read through L2: past the first tier other
// blocks wrote it.
template <class C, class X>
__device__ __forceinline__ void tree_pair_level(
    const PointPtrs& src, size_t stride, size_t at, size_t n, size_t base,
    size_t u, int levels, int m, unsigned lt, const PointPtrs& slots,
    size_t nslots, size_t slot0) {
  const unsigned q = lt >> 1, wq = (lt & ~31u) >> 1;
  const unsigned pairs = 1u << (levels - 1 - m);
  if (wq >= pairs) return;                      // the whole warp
  const bool h = lt & 1;
  const size_t count = (n - base + u - 1) / u;
  const size_t i = (size_t)q << (m + 1), j = i + ((size_t)1 << m);
  const bool has = q < pairs && i < count, two = has && j < count;
  Pt<C> a, b;
  if (m == 0) {
    a = load_point<C, true>(src, stride, at + base + (has ? i : 0) * u);
    b = two ? load_point<C, true>(src, stride, at + base + j * u)
            : pt_identity<C>();
  } else {
    a = load_point<C>(slots, nslots, slot0 + (has ? i >> 1 : 0));
    b = two ? load_point<C>(slots, nslots, slot0 + (j >> 1))
            : pt_identity<C>();
  }
  const Pt<C> r = pt_add_pair<C, X>(a, b, h);
  if (has && !h) store_point(r, slots, nslots, slot0 + (i >> 1));
}

#if defined(__CUDACC__)
// tree_sum_block's barrier and count of arrivals on the card: thread 0
// fences its root's store before it counts, and the last to count fences
// before its block reads the others' roots (threadfence reduction)
struct TreeBlock {
  unsigned* flag;                         // one word of shared memory
  __device__ void sync() const { __syncthreads(); }
  __device__ bool arrive(unsigned* c, unsigned groups) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      const bool last = atomicAdd(c, 1u) + 1 == groups;
      if (last) __threadfence();
      *flag = last;
    }
    __syncthreads();
    return *flag;
  }
};
#endif

// Block ``blk`` of tree_shape<K>(batch, n).blocks, run by its thread t of
// 2^K.  ``slots``: 2^(K-1) points of shared memory; ``count``: zeroed
// words, one per row for each group of every tier past the first (at
// most ceil(n / 2) a row for K >= 2).  ``sched.sync()`` is the block's
// barrier; ``sched.arrive(c, groups)`` (called by every thread after
// thread 0 stored its group's root) counts the block's arrival at word c
// and tells every thread whether it brought it to ``groups``.
template <class C, class X, int K, class B>
__device__ __forceinline__ void tree_sum_block(
    const PointPtrs& in, const PointPtrs& scratch, const PointPtrs& out,
    size_t batch, size_t n, size_t blk, unsigned t, const PointPtrs& slots,
    unsigned* count, B& sched) {
  static_assert(K >= 2, "a tier of at least two levels");
  const TreeShape s = tree_shape<K>(batch, n);
  const size_t stride = batch * n;
  if (s.levels == 0) {
    const size_t row = (blk << K) + t;
    if (row < batch)
      store_point(load_point<C>(in, batch, row), out, batch, row);
    return;
  }
  const unsigned lt = t & ((1u << s.first) - 1);
  const size_t total = batch * s.groups;
  size_t sub = blk * s.per_block + (t >> s.first);
  const bool live = sub < total;
  if (!live) sub = total - 1;
  const size_t b = sub / s.groups;
  const size_t slot0 = (size_t)(t >> s.first) << (s.first - 1);
  size_t g = sub - b * s.groups, u = 1, counted = 0;
#pragma unroll 1
  for (int done = 0;; done += K) {
    const int levels = s.levels - done < K ? s.levels - done : K;
    const size_t base = g * (u << K);
    const size_t nslots = (size_t)1 << (K - 1);
#pragma unroll 1
    for (int m = 0; m < levels; m++) {
      tree_pair_level<C, X>(done ? scratch : in, stride, b * n, n, base, u,
                            levels, m, lt, slots, nslots, slot0);
      if (m + 1 < levels) sched.sync();
    }
    // the group's root, in its slot 0 from its first thread
    if (done + levels == s.levels) {
      if (live && lt == 0)
        store_point(load_point<C>(slots, nslots, slot0), out, batch, b);
      return;
    }
    // here L > K: one group a block
    if (t == 0)
      store_point(load_point<C>(slots, nslots, 0), scratch, stride,
                  b * n + base);
    const size_t groups = (n + (u << K) - 1) / (u << K);
    const size_t parent = g >> K;
    const size_t sibs = groups - (parent << K);
    if (!sched.arrive(count + (counted + parent) * batch + b,
                      (unsigned)(sibs < ((size_t)1 << K) ? sibs
                                                         : (size_t)1 << K)))
      return;
    counted += (groups + ((size_t)1 << K) - 1) >> K;
    g = parent;
    u <<= K;
  }
}

// msm._hs_prefix over each row of the [8, batch, n] batch ``in``: level l
// (l < L = ceil(log2 n)) makes element j of a row pt_add(element j of
// level l - 1, element j - 2^l of it), the identity in place of the second
// where j < 2^l; level -1 is ``in``, level L - 1 is ``out``.  Every add of
// that dataflow runs, the identity's included, with the same operands in
// the same order, so the words are prefix_sum_plain's (optionally, phase
// 2's adds of the identity as pt_add_identity, which gives their words).
//
// For l >= m, j - 2^l = j (mod 2^m): levels m .. L - 1 never leave a
// residue class mod 2^m, and each class is a Hillis-Steele scan of its
// own.  So the levels run in two phases of items, one block an item:
//  1. levels 0 .. min(m, L) - 1 on tiles of the flattened batch: an item
//     makes its tile and the 2^m - 1 elements before it (a halo, whose
//     adds it recomputes: the same adds of the same operands) level by
//     level, the first from ``in``, the later ones in shared memory, the
//     last into ``out``, then counts its arrival at each row it touched;
//  2. levels m .. L - 1 (where L > m) on the classes of a row, 2^clog
//     consecutive residues an item (as many as one round of the block's
//     workers takes, at least one): an item waits until every tile of its
//     row has arrived, then runs the levels likewise, the first from
//     ``out``, the last into ``out``.
// A level runs over the item's slots, a slot a worker (one thread:
// pt_add; or the two threads of a pair: pt_add_pair) and round, from one
// shared-memory buffer into the other, one barrier a level.  Classes
// longer than a buffer, and a phase 2 of one level, run on ``out`` in
// place (``in_place``) from the top down: a slot's operands lie at or
// below it, so a round's reads precede its writes across a barrier and
// no later round writes what an earlier one read.  One add in the loop:
// a second inlined G2 add doubles the kernel's registers.

// the items of a launch for blocks of ``workers`` workers, ``rounds`` of
// them a tile's first level, and buffers of ``slots`` points (at least
// rounds x workers + 1)
struct PrefixShape {
  size_t batch, n;
  int levels;       // L
  int first;        // phase 1's levels: min(m, L)
  int m;            // phase 2's classes: residues mod 2^m
  int clog;         // phase 2: 2^clog classes an item
  size_t halo;      // 2^first - 1
  size_t tile;      // elements of the flattened batch a tile stores
  size_t tiles;     // phase-1 items
  size_t groups;    // phase-2 items a row (0 where L <= m)
  bool in_place;    // phase 2 on ``out``: 2^clog ceil(n / 2^m) > slots
  size_t items;     // tiles + batch groups
};

__host__ __device__ inline PrefixShape prefix_shape(size_t batch, size_t n,
                                                    int m, size_t workers,
                                                    size_t rounds,
                                                    size_t slots) {
  PrefixShape s;
  s.batch = batch;
  s.n = n;
  s.levels = 0;
  while (((size_t)1 << s.levels) < n) s.levels++;
  s.m = m;
  s.first = s.levels < m ? s.levels : m;
  s.halo = ((size_t)1 << s.first) - 1;
  // level 0 makes the tile and all of the halo but its first element
  s.tile = rounds * workers - (s.first ? s.halo - 1 : 0);
  s.tiles = (batch * n + s.tile - 1) / s.tile;
  s.clog = 0;
  s.groups = 0;
  s.in_place = false;
  if (s.levels > m) {
    const size_t len = (n + ((size_t)1 << m) - 1) >> m;  // the longest class
    while (s.clog < m && (len << (s.clog + 1)) <= workers) s.clog++;
    s.groups = (size_t)1 << (m - s.clog);
    s.in_place = (len << s.clog) > slots;
  }
  s.items = s.tiles + batch * s.groups;
  return s;
}

#if defined(__CUDACC__)
// prefix_sum_item's barrier, count of arrivals and wait on the card: a
// tile's stores fenced before it counts, the count read (and fenced)
// before the waiting item's loads, which go through L2
struct PrefixBlock {
  __device__ void sync() const { __syncthreads(); }
  __device__ void arrive(unsigned* c, unsigned first, unsigned last) const {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      for (unsigned b = first; b <= last; b++) atomicAdd(c + b, 1u);
    }
  }
  __device__ void wait(const unsigned* c, unsigned target) const {
    if (threadIdx.x == 0) {
      while (*(const volatile unsigned*)c < target) {
      }
      __threadfence();
    }
    __syncthreads();
  }
};
#endif

// what thread h of a worker of T threads stores of a sum (a pair: X and Z
// from h = 0, Y from h = 1)
template <int T, class C>
__device__ __forceinline__ void store_part(const Pt<C>& r, const PointPtrs& p,
                                           size_t stride, size_t i, bool h) {
  if (T == 1) {
    store_point(r, p, stride, i);
  } else if (h) {
    store_coord(r.y, p, 1, stride, i);
  } else {
    store_coord(r.x, p, 0, stride, i);
    store_coord(r.z, p, 2, stride, i);
  }
}

// The library's prefix (prefix_kernels.cu) by coordinate type (D = 1:
// G1, 2: G2), chosen by measurement (PERF.md, scripts/prefix_designs.py):
// phase 2's classes mod 2^kLog, kThreads threads a worker, blocks of
// kBlock threads, kRounds rounds of workers a tile's first level, buffers
// of kSlots points, at least kMinBlocks blocks an SM (the register cap),
// phase 2's adds of the identity by pt_add_identity (kIdentity; on G2 it
// slowed BN254b's loop).
template <int D>
struct PrefixConfig;
template <>
struct PrefixConfig<1> {
  static constexpr int kLog = 4, kThreads = 1, kBlock = 128, kRounds = 1,
                       kSlots = 257, kMinBlocks = 3;
  static constexpr bool kIdentity = true;
};
template <>
struct PrefixConfig<2> {
  static constexpr int kLog = 4, kThreads = 2, kBlock = 128, kRounds = 4,
                       kSlots = 257, kMinBlocks = 2;
  static constexpr bool kIdentity = false;
};
template <class C>
using PrefixOf = PrefixConfig<(int)(sizeof(C) / 32)>;

// The points of buffer k of an item's shared memory (two buffers of S
// points, kComps components of 8 words each)
template <class C, int S>
__device__ __forceinline__ PointPtrs prefix_buffer(uint32_t* smem, int k) {
  constexpr int kComps = 3 * (int)(sizeof(C) / 32);
  PointPtrs p;
#pragma unroll
  for (int c = 0; c < 6; c++)
    p.c[c] = c < kComps ? smem + (size_t)(k * kComps + c) * 8 * S : nullptr;
  return p;
}

// Item ``item`` of s (prefix_shape, with S slots; a flattened batch of
// fewer than 2^32 points) on the ``block`` threads of a block, run by its
// thread t, T threads a worker (1: pt_add; 2: pt_add_pair with exchange
// X; a warp's workers take consecutive slots; ID: phase 2's adds of the
// identity by pt_add_identity, where a warp has no other).  ``smem``: 2 S
// points; ``count``: s.batch zeroed words, a row's arrived tiles.
// ``sched``: sync() the block's barrier; arrive(c, first, last) (every
// thread, after the tile's stores) counts the tile at words first .. last
// of c; wait(c, target) (every thread) returns once word c has reached
// target.
template <class C, class X, int T, int S, bool ID, class B>
__device__ __forceinline__ void prefix_sum_item(
    const PointPtrs& in, const PointPtrs& out, const PrefixShape& s,
    unsigned item, unsigned t, unsigned block, uint32_t* smem,
    unsigned* count, B& sched) {
  const unsigned n = (unsigned)s.n, total = (unsigned)(s.batch * s.n);
  const bool tile = item < s.tiles;
  // slot i is element base + ((i >> sh) << step) + (i & mask) of the
  // flattened batch (none at or past lim); the item's slots: [skip, hi)
  unsigned base, lim, hi, skip = 0, first_row = 0, last_row = 0;
  int sh = 0, step = 0, l0, l1;
  if (tile) {
    const unsigned t0 = item * (unsigned)s.tile;
    const unsigned end = total - t0 > s.tile ? t0 + (unsigned)s.tile : total;
    if (s.first == 0) {                       // n = 1: a copy
      for (unsigned f = t0 + t; f < end; f += block)
        store_point(load_point<C>(in, total, f), out, total, f);
      return;
    }
    base = t0 - (unsigned)s.halo;           // modulo 2^32 where t0 < halo
    lim = total;
    skip = s.halo > t0 ? (unsigned)s.halo - t0 : 0;
    hi = end - base;
    l0 = 0;
    l1 = s.first;
    first_row = t0 / n;
    last_row = (end - 1) / n;
  } else {
    const unsigned k = item - (unsigned)s.tiles;
    const unsigned b = k / (unsigned)s.groups;
    const unsigned r0 = (k - b * (unsigned)s.groups) << s.clog;
    base = b * n + r0;
    lim = b * n + n;
    sh = s.clog;
    step = s.m;
    hi = ((n - r0 + (1u << s.m) - 1) >> s.m) << s.clog;
    l0 = s.m;
    l1 = s.levels;
    // every tile that touches row b
    const unsigned tl = (unsigned)s.tile;
    sched.wait(count + b, ((b + 1) * n - 1) / tl - b * n / tl + 1);
  }
  const unsigned mask = (1u << sh) - 1;
  // phase 2 on ``out`` in place, a barrier between each round's reads and
  // its writes: where its classes exceed the slots, or where it has one
  // level (which reads ``out`` and writes it)
  const bool on_out = !tile && (s.in_place || l1 - l0 == 1);
  const unsigned workers = block / T, me = t / T, warp0 = (t & ~31u) / T;
  const bool h = T == 2 && (t & 1);
#pragma unroll 1
  for (int l = l0; l < l1; l++) {
    // the first level reads the item's input (``in``, or the row's tiles
    // in ``out``); the others buffer (l - l0 - 1) & 1, which the level
    // before wrote; the last writes ``out``
    const bool from_mem = l == l0 || on_out, last = l + 1 == l1;
    const PointPtrs src = prefix_buffer<C, S>(smem, (l - l0 + 1) & 1);
    const PointPtrs dst = prefix_buffer<C, S>(smem, (l - l0) & 1);
    // the operand's distance in slots: element j - 2^l
    const unsigned dist = 1u << (l - step + sh);
    const unsigned lo = tile && (2u << l) - 1 > skip ? (2u << l) - 1 : skip;
    const unsigned cnt = hi - lo, rounds = (cnt + workers - 1) / workers;
#pragma unroll 1
    for (unsigned r = 0; r < rounds; r++) {
      const unsigned idx = r * workers + me;
      unsigned i = idx < cnt ? hi - 1 - idx : lo;
      unsigned g = base + ((i >> sh) << step) + (i & mask);
      const bool live = idx < cnt && g < lim;
      if (!live) {
        i = lo;
        g = base + ((lo >> sh) << step) + (lo & mask);
      }
      Pt<C> sum;
      if (r * workers + warp0 < cnt) {     // a worker of the warp has a slot
        // the second operand is the identity where j < 2^l: in phase 2,
        // where i < dist, so for every slot of the warp where its first
        // worker's is (its slots run down from there)
        const bool ident = !live || (tile ? g % n < (1u << l) : i < dist);
        const bool all_ident =
            ID && !tile && hi - 1 - (r * workers + warp0) < dist;
        const unsigned gb = g - (1u << l);
        if (all_ident) {
          sum = pt_add_identity<T>(from_mem ? load_point<C, true>(out, total, g)
                                            : load_point<C>(src, S, i),
                                   h);
        } else {
          Pt<C> a, b;
          if (!from_mem) {
            a = load_point<C>(src, S, i);
            b = ident ? pt_identity<C>() : load_point<C>(src, S, i - dist);
          } else if (tile) {
            a = load_point<C>(in, total, g);
            b = ident ? pt_identity<C>() : load_point<C>(in, total, gb);
          } else {
            a = load_point<C, true>(out, total, g);
            b = ident ? pt_identity<C>()
                      : load_point<C, true>(out, total, gb);
          }
          if constexpr (T == 2) sum = pt_add_pair<C, X>(a, b, h);
          else sum = pt_add(a, b);
        }
      }
      if (on_out) sched.sync();
      if (live) {
        if (last || on_out) store_part<T>(sum, out, total, g, h);
        else store_part<T>(sum, dst, S, i, h);
      }
    }
    if (!last) sched.sync();
  }
  if (tile && s.groups) sched.arrive(count, first_row, last_row);
}

// A fixed-base window table (msm._window_table) round by round.  The
// masked loop adds the set bits of an entry's digit d in increasing order
// from the identity, so for d in [2^t, 2^(t+1)) the entry without its top
// bit t is the prefix of d's chain:
//   T[win][0] = the identity (0, 1, 0)
//   T[win][d] = pt_add(T[win][d - 2^t], [2^(win w + t)] G)
// the same add with the same operands in the same order, so the same
// words, and one add per entry: outerc (2^w - 1) in all.  Round t makes
// the entries [2^t, 2^(t+1)) of every window from those of the rounds
// before it.  [2^0] G is ``base`` (one point); [2^j] G for j >= 1 is point
// j - 1 of ``powers`` (npow points, the doubling chain).  ``out``: [8,
// outerc, 2^w].
template <class C>
__device__ __forceinline__ void table_add(const PointPtrs& base,
                                          const PointPtrs& powers,
                                          size_t npow, const PointPtrs& out,
                                          int w, int outerc, size_t win,
                                          int t, size_t j) {
  const size_t entries = (size_t)outerc << w, row = win << w;
  const size_t k = win * w + t;
  const Pt<C> g = k == 0 ? load_point<C>(base, 1, 0)
                         : load_point<C>(powers, npow, k - 1);
  store_point(pt_add(load_point<C>(out, entries, row + j), g), out, entries,
              row + ((size_t)1 << t) + j);
}

// The whole table: the first ``block_rounds`` rounds of each window on one
// block (``sched.blocks`` gives the block its windows, ``sched.threads``
// a thread its entries, ``sched.sync()`` separates the rounds), the rest
// across the grid (``sched.range``, ``sched.barrier()`` before each round,
// as for tree_sum_rows).  A round reads only entries that earlier rounds
// wrote.  One call of table_add in the loop: a second inlined G2 add
// doubles the kernel's registers and spills.
template <class C, class Sched>
__device__ __forceinline__ void window_table_rounds(
    const PointPtrs& base, const PointPtrs& powers, size_t npow, int w,
    int outerc, const PointPtrs& out, int block_rounds, Sched& sched) {
  const size_t entries = (size_t)outerc << w;
  const ItemRange mine = sched.blocks(outerc);
  const ItemRange zero = sched.threads(1);
  for (size_t win = mine.first; win < mine.end; win += mine.step)
    for (size_t i = zero.first; i < zero.end; i += zero.step)
      store_point(pt_identity<C>(), out, entries, win << w);
#pragma unroll 1
  for (int t = 0; t < w; t++) {
    const size_t half = (size_t)1 << t;
    // on a block: its windows, and per window the thread's entries; across
    // the grid: one pass over the thread's items (window, entry)
    const bool on_block = t < block_rounds;
    if (on_block) sched.sync();
    else sched.barrier();
    const ItemRange wins = on_block ? mine : ItemRange{0, 1, 1};
    const ItemRange it = on_block ? sched.threads(half)
                                  : sched.range(outerc, half);
#pragma unroll 1
    for (size_t v = wins.first; v < wins.end; v += wins.step) {
#pragma unroll 1
      for (size_t i = it.first; i < it.end; i += it.step)
        table_add<C>(base, powers, npow, out, w, outerc,
                     on_block ? v : i >> t, t, on_block ? i : i & (half - 1));
    }
  }
}
