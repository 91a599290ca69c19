// Field and curve arithmetic with each base-field element spread over the
// eight lanes of a group of a warp: lane k of the group holds word k.  A
// warp is four such groups, and the formulas run their independent
// products at once, one on each group (CGBN's layout, several threads per
// big number, for the chains whose time is one thread's latency).
//
// The code is written over a lane policy L, the small interface the warp
// offers: U32 / U64 / Pred (a lane's 32-bit word, 64-bit word, predicate),
// lane(), shfl(v, src) (v of lane src), ballot(pred) (one bit per lane,
// the same word on every lane), load / store of a lane's own word.  On the
// card L is WarpLanes (registers, __shfl_sync, __ballot_sync); a host
// harness can give a warp emulated by a loop over 32 lanes, so the same
// source runs serially on the CPU (tests/test_torch_csrc_host.py).  All
// 32 lanes run every collective: no code here branches on a lane's data,
// a lane-dependent choice is a select (sel).
//
// Every function returns the canonical value in [0, p) that field.cuh's
// one-thread function returns, so the formulas below, which compute the
// same field elements as rcb.cuh's, give the same projective words.
#pragma once
#include "rcb.cuh"

namespace lanes {

template <class T>
__host__ __device__ __forceinline__ T sel(bool c, T a, T b) {
  return c ? a : b;
}

#if defined(__CUDACC__)
// The warp of the card.
struct WarpLanes {
  typedef uint32_t U32;
  typedef uint64_t U64;
  typedef bool Pred;
  static __device__ __forceinline__ U32 lane() { return threadIdx.x & 31u; }
  static __device__ __forceinline__ U32 shfl(U32 v, U32 src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
  static __device__ __forceinline__ uint32_t ballot(Pred p) {
    return __ballot_sync(0xffffffffu, p);
  }
  static __device__ __forceinline__ U32 load(const uint32_t* base,
                                             size_t stride, size_t i, U32 k) {
    return base[(size_t)k * stride + i];
  }
  static __device__ __forceinline__ void store(uint32_t* base, size_t stride,
                                               size_t i, U32 k, U32 v,
                                               Pred on) {
    if (on) base[(size_t)k * stride + i] = v;
  }
};
#endif

// word k of a constant of the modulus M (W<M>::get(j): its word j)
template <template <class> class W, class M, class L>
__device__ __forceinline__ typename L::U32 pick(typename L::U32 k) {
  typedef typename L::U32 U32;
  U32 r = U32(W<M>::get(7));
#pragma unroll
  for (int j = 6; j >= 0; j--)
    r = sel(k == U32((uint32_t)j), U32(W<M>::get(j)), r);
  return r;
}
template <class M>
struct PWord {
  static __device__ __forceinline__ uint32_t get(int j) {
    return M::p(j);
  }
};
template <class M>
struct OneWord {
  static __device__ __forceinline__ uint32_t get(int j) {
    return M::one(j);
  }
};
template <class M>
struct B3C0Word {
  static __device__ __forceinline__ uint32_t get(int j) {
    return M::b3_c0(j);
  }
};
template <class M>
struct B3C1Word {
  static __device__ __forceinline__ uint32_t get(int j) {
    return M::b3_c1(j);
  }
};

template <class L>
__device__ __forceinline__ typename L::U32 word_index() {
  return L::lane() & 7u;
}
template <class L>
__device__ __forceinline__ typename L::U32 group_first() {
  return L::lane() & ~7u;
}

// The carries of a sum over the eight lanes of every group at once
// (CGBN's propagation by ballot).  ``gen``: the lane's word carried out;
// ``prop``: a carry into the lane would pass on (the word is all ones).
// The two never hold together.  With g and p the group's eight bits, the
// carry into lane k is bit k of ((g << 1) + p) ^ p, and bit 8 of the sum
// is the group's carry out (``out``).  Returns the lane's carry in.  The
// same reading serves a difference: borrow out, and a word of zero.
// (Resolving a sum and the subtract of p that follows from one round of
// six ballots, each lane offering the subtract's flags for either carry,
// ran a G2 combine slower on the H100: it trades two ballot latencies for
// more instructions, and a warp running a G2 formula's many independent
// adds is bound by issue rather than by latency.)
template <class L>
__device__ __forceinline__ typename L::U32 resolve(typename L::Pred gen,
                                                   typename L::Pred prop,
                                                   typename L::U32& out) {
  typedef typename L::U32 U32;
  const uint32_t g = L::ballot(gen), p = L::ballot(prop);
  const U32 at = group_first<L>();
  const U32 gm = (U32(g) >> at) & 0xFFu, pm = (U32(p) >> at) & 0xFFu;
  const U32 s = (gm << 1) + pm;
  out = s >> 8;
  return ((s ^ pm) >> word_index<L>()) & 1u;
}

// an element of Fp (M: the modulus), word k in lane k of each group
template <class M, class L>
struct LFp {
  typename L::U32 w;
};

template <class M, class L>
__device__ __forceinline__ typename L::U32 p_word() {
  return pick<PWord, M, L>(word_index<L>());
}

template <class M, class L>
__device__ __forceinline__ LFp<M, L> lfp_zero() {
  return {typename L::U32(0u)};
}

template <class M, class L>
__device__ __forceinline__ LFp<M, L> lfp_one() {
  return {pick<OneWord, M, L>(word_index<L>())};
}

// s - p if s >= p, else s  (s < 2p)
template <class M, class L>
__device__ __forceinline__ LFp<M, L> reduce_once(typename L::U32 s) {
  typedef typename L::U32 U32;
  const U32 pw = p_word<M, L>();
  U32 d = s - pw, below;
  d = d - resolve<L>(s < pw, d == U32(0u), below);
  return {sel(below != U32(0u), s, d)};
}

template <class M, class L>
__device__ __forceinline__ LFp<M, L> add(const LFp<M, L>& a,
                                         const LFp<M, L>& b) {
  typedef typename L::U32 U32;
  U32 s = a.w + b.w, out;
  s = s + resolve<L>(s < a.w, s == U32(0xffffffffu), out);  // < 2p: out = 0
  return reduce_once<M, L>(s);
}

template <class M, class L>
__device__ __forceinline__ LFp<M, L> dbl(const LFp<M, L>& a) {
  return add(a, a);
}

// a - b, plus p where that borrowed (the carry out of that add is 2^256,
// dropped)
template <class M, class L>
__device__ __forceinline__ LFp<M, L> sub(const LFp<M, L>& a,
                                         const LFp<M, L>& b) {
  typedef typename L::U32 U32;
  U32 d = a.w - b.w, borrow, out;
  d = d - resolve<L>(a.w < b.w, d == U32(0u), borrow);
  const U32 q = sel(borrow != U32(0u), p_word<M, L>(), U32(0u));
  U32 s = d + q;
  s = s + resolve<L>(s < d, s == U32(0xffffffffu), out);
  return {s};
}

// k * a by fields/fp.py mul_small's chain (field.cuh mul_small)
template <unsigned K, class M, class L>
__device__ __forceinline__ LFp<M, L> mul_small(const LFp<M, L>& a) {
  static_assert(K > 0, "mul_small needs k > 0");
  if constexpr (K == 1) {
    return a;
  } else if constexpr (K & 1u) {
    return add(a, mul_small<K / 2>(dbl(a)));
  } else {
    return mul_small<K / 2>(dbl(a));
  }
}

// The Montgomery product x * y * R^-1 mod p of each group's own operands
// (word k in lane k), CIOS over the group's lanes.  Lane k holds word r_k
// of the running value and a carry c_k that weighs word k + 1: V = sum
// r_k 2^(32 k) + sum c_k 2^(32 (k + 1)).  A round adds x * y_i (y_i
// broadcast from lane i) and m * p (m from lane 0's word, which it makes
// zero), then divides by 2^32: column k takes r_(k+1) from the lane above
// and its own c_k (lane 7 takes lane 0's word, that zero).  Each step
// adds below 2^64 to a word, so c_k stays below 2^34 inside a round and
// below 4 after it; V stays below 2p between rounds (field.cuh).  After
// the last round the carries are added in by ballot (V < 2^256, so none
// leaves the group: c_7 = 0) and one conditional subtract makes the value
// canonical.
template <class M, class L>
__device__ __forceinline__ typename L::U32 mont_mul(typename L::U32 x,
                                                    typename L::U32 y) {
  typedef typename L::U32 U32;
  typedef typename L::U64 U64;
  const U32 k = word_index<L>(), first = group_first<L>();
  const U32 pw = p_word<M, L>();
  const U32 above = first + ((k + 1u) & 7u);
  U32 r = U32(0u);
  U64 c = U64(0u);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const U32 yi = L::shfl(y, first + U32((uint32_t)i));
    U64 t = U64(r) + U64(x) * U64(yi);
    c = c + (t >> 32);
    r = U32(t);
    const U32 m = L::shfl(r, first) * U32(M::N0INV);
    t = U64(r) + U64(pw) * U64(m);
    c = c + (t >> 32);
    r = U32(t);
    t = U64(L::shfl(r, above)) + c;
    r = U32(t);
    c = t >> 32;
  }
  const U32 below = first + ((k + 7u) & 7u);
  const U32 cin = sel(k == U32(0u), U32(0u), L::shfl(U32(c), below));
  U32 v = r + cin, out;
  v = v + resolve<L>(v < r, v == U32(0xffffffffu), out);
  return reduce_once<M, L>(v).w;
}

// r[i] = a[i] * b[i] for i < N, the same operands on every group: product
// i runs on group i % 4 in round i / 4, then every group takes every
// result (one shuffle each).
template <int N, class M, class L>
__device__ __forceinline__ void mul_n(const LFp<M, L>* a, const LFp<M, L>* b,
                                      LFp<M, L>* r) {
  typedef typename L::U32 U32;
  const U32 g = L::lane() >> 3, k = word_index<L>();
#pragma unroll
  for (int s = 0; s < N; s += 4) {
    U32 x = a[s].w, y = b[s].w;
#pragma unroll
    for (int j = 1; j < 4 && s + j < N; j++) {
      x = sel(g == U32((uint32_t)j), a[s + j].w, x);
      y = sel(g == U32((uint32_t)j), b[s + j].w, y);
    }
    const U32 p = mont_mul<M, L>(x, y);
#pragma unroll
    for (int j = 0; j < 4 && s + j < N; j++)
      r[s + j].w = L::shfl(p, U32((uint32_t)(8 * j)) + k);
  }
}

// Fp2 = Fp[u]/(u^2 - nr), as fp2.cuh
template <class M, class L>
struct LFp2 {
  LFp<M, L> c0, c1;
};

template <class M, class L>
__device__ __forceinline__ LFp2<M, L> add(const LFp2<M, L>& a,
                                          const LFp2<M, L>& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
template <class M, class L>
__device__ __forceinline__ LFp2<M, L> sub(const LFp2<M, L>& a,
                                          const LFp2<M, L>& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
template <class M, class L>
__device__ __forceinline__ LFp2<M, L> dbl(const LFp2<M, L>& a) {
  return {dbl(a.c0), dbl(a.c1)};
}

// the Karatsuba products of fp2.cuh mul, three base products each, all
// 3 N spread over the groups: c0 = t0 + nr t1, c1 = s - t0 - t1
template <int N, class M, class L>
__device__ __forceinline__ void mul_n(const LFp2<M, L>* a, const LFp2<M, L>* b,
                                      LFp2<M, L>* r) {
  LFp<M, L> x[3 * N], y[3 * N], t[3 * N];
#pragma unroll
  for (int i = 0; i < N; i++) {
    x[3 * i] = a[i].c0;
    y[3 * i] = b[i].c0;
    x[3 * i + 1] = a[i].c1;
    y[3 * i + 1] = b[i].c1;
    x[3 * i + 2] = add(a[i].c0, a[i].c1);
    y[3 * i + 2] = add(b[i].c0, b[i].c1);
  }
  mul_n<3 * N>(x, y, t);
  static_assert(M::kNr < 0, "the non-residue is negative");
#pragma unroll
  for (int i = 0; i < N; i++) {
    const LFp<M, L>&t0 = t[3 * i], &t1 = t[3 * i + 1];
    r[i].c0 = sub(t0, mul_small<(unsigned)-M::kNr>(t1));
    r[i].c1 = sub(sub(t[3 * i + 2], t0), t1);
  }
}

// r[i] = b3 a[i]: on G1 the addition chain, on G2 the product by the
// twist's constant, the N products spread over the groups
template <int N, class M, class L>
__device__ __forceinline__ void mul_b3_n(const LFp<M, L>* a, LFp<M, L>* r) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = mul_small<M::kB3>(a[i]);
}
template <int N, class M, class L>
__device__ __forceinline__ void mul_b3_n(const LFp2<M, L>* a,
                                         LFp2<M, L>* r) {
  const typename L::U32 k = word_index<L>();
  const LFp2<M, L> b3 = {{pick<B3C0Word, M, L>(k)},
                         {pick<B3C1Word, M, L>(k)}};
  LFp2<M, L> b[N];
#pragma unroll
  for (int i = 0; i < N; i++) b[i] = b3;
  mul_n<N>(a, b, r);
}

template <class M, class L>
__device__ __forceinline__ void coord_zero(LFp<M, L>& c) {
  c = lfp_zero<M, L>();
}
template <class M, class L>
__device__ __forceinline__ void coord_one(LFp<M, L>& c) {
  c = lfp_one<M, L>();
}
template <class M, class L>
__device__ __forceinline__ void coord_zero(LFp2<M, L>& c) {
  c.c0 = lfp_zero<M, L>();
  c.c1 = lfp_zero<M, L>();
}
template <class M, class L>
__device__ __forceinline__ void coord_one(LFp2<M, L>& c) {
  c.c0 = lfp_one<M, L>();
  c.c1 = lfp_zero<M, L>();
}

// The spread coordinate of a one-thread coordinate type (curve.cuh's
// G1Coord, G2Coord).
template <class C, class L>
struct Spread;
template <class M, class L>
struct Spread<Fp<M>, L> {
  typedef LFp<M, L> type;
};
template <class M, class L>
struct Spread<Fp2<M>, L> {
  typedef LFp2<M, L> type;
};

// P + Q (rcb.cuh pt_add, algorithm 7) in two levels of six products and,
// between them, the two products by b3
template <class C>
__device__ __forceinline__ Pt<C> pt_add(const Pt<C>& p, const Pt<C>& q) {
  const C a[6] = {p.x, p.y, p.z, add(p.x, p.y), add(p.y, p.z),
                  add(p.x, p.z)};
  const C b[6] = {q.x, q.y, q.z, add(q.x, q.y), add(q.y, q.z),
                  add(q.x, q.z)};
  C t[6];
  mul_n<6>(a, b, t);
  const C t3 = sub(t[3], add(t[0], t[1]));
  const C t4 = sub(t[4], add(t[1], t[2]));
  const C t5 = sub(t[5], add(t[0], t[2]));
  const C three_t0 = add(dbl(t[0]), t[0]);
  const C in_b3[2] = {t[2], t5};
  C b3[2];                                // b3 t2, y3 = b3 t5
  mul_b3_n<2>(in_b3, b3);
  const C z3 = add(t[1], b3[0]);
  const C t1 = sub(t[1], b3[0]);
  const C u[6] = {t3, t4, b3[1], t1, z3, three_t0};
  const C v[6] = {t1, b3[1], three_t0, z3, t4, t3};
  C m[6];
  mul_n<6>(u, v, m);
  Pt<C> r;
  r.x = sub(m[0], m[1]);
  r.y = add(m[2], m[3]);
  r.z = add(m[4], m[5]);
  return r;
}

// [2]P (rcb.cuh pt_double, algorithm 9) in two levels of four products
// and, between them, the product by b3
template <class C>
__device__ __forceinline__ Pt<C> pt_double(const Pt<C>& p) {
  const C a[4] = {p.y, p.y, p.z, p.x};
  const C b[4] = {p.y, p.z, p.z, p.y};
  C t[4];                                 // y^2, y z, z^2, x y
  mul_n<4>(a, b, t);
  const C z3 = dbl(dbl(dbl(t[0])));
  C t2;
  mul_b3_n<1>(&t[2], &t2);
  const C y3a = add(t[0], t2);
  const C t0 = sub(t[0], add(dbl(t2), t2));
  const C u[4] = {t0, t2, t0, t[1]};
  const C v[4] = {t[3], z3, y3a, z3};
  C m[4];
  mul_n<4>(u, v, m);
  Pt<C> r;
  r.x = dbl(m[0]);
  r.y = add(m[1], m[2]);
  r.z = m[3];
  return r;
}

// Point batches as in rcb.cuh (PointPtrs); every group loads the whole
// point, word k in lane k.  (The point functions share their names with
// rcb.cuh's, whose types ADL also sees: call them as lanes::.)
template <class M, class L>
__device__ __forceinline__ void load_coord(LFp<M, L>& c, const PointPtrs& p,
                                           int ci, size_t n, size_t i) {
  c.w = L::load(p.c[ci], n, i, word_index<L>());
}
template <class M, class L>
__device__ __forceinline__ void load_coord(LFp2<M, L>& c, const PointPtrs& p,
                                           int ci, size_t n, size_t i) {
  c.c0.w = L::load(p.c[2 * ci], n, i, word_index<L>());
  c.c1.w = L::load(p.c[2 * ci + 1], n, i, word_index<L>());
}

// group 0 stores
template <class M, class L>
__device__ __forceinline__ void store_coord(const LFp<M, L>& c,
                                            const PointPtrs& p, int ci,
                                            size_t n, size_t i) {
  L::store(p.c[ci], n, i, word_index<L>(), c.w, L::lane() < 8u);
}
template <class M, class L>
__device__ __forceinline__ void store_coord(const LFp2<M, L>& c,
                                            const PointPtrs& p, int ci,
                                            size_t n, size_t i) {
  L::store(p.c[2 * ci], n, i, word_index<L>(), c.c0.w, L::lane() < 8u);
  L::store(p.c[2 * ci + 1], n, i, word_index<L>(), c.c1.w, L::lane() < 8u);
}

template <class C>
__device__ __forceinline__ Pt<C> load_point(const PointPtrs& p, size_t n,
                                            size_t i) {
  Pt<C> r;
  load_coord(r.x, p, 0, n, i);
  load_coord(r.y, p, 1, n, i);
  load_coord(r.z, p, 2, n, i);
  return r;
}

template <class C>
__device__ __forceinline__ void store_point(const Pt<C>& r, const PointPtrs& p,
                                            size_t n, size_t i) {
  store_coord(r.x, p, 0, n, i);
  store_coord(r.y, p, 1, n, i);
  store_coord(r.z, p, 2, n, i);
}

// kernel (e)'s doubling chain of point i of a batch of n, on one warp:
// ``times`` doublings; with ``every_step`` each [2^(j+1)]P is stored at
// i * times + j of a batch of n * times as it is made, else the last at i
template <class C>
__device__ __forceinline__ void double_chain(const PointPtrs& p,
                                             const PointPtrs& out, size_t n,
                                             size_t i, int times,
                                             bool every_step) {
  Pt<C> q = lanes::load_point<C>(p, n, i);
#pragma unroll 1
  for (int j = 0; j < times; j++) {
    q = lanes::pt_double(q);
    if (every_step) lanes::store_point(q, out, n * times, i * times + j);
  }
  if (!every_step) lanes::store_point(q, out, n, i);
}

// msm._combine_windows for one accumulator, on one warp: from the
// identity, most significant window first, acc = [2^c] acc + W_j over the
// ``num_win`` window results at at, at + 1, ...  (the order of rcb.cuh's
// adds and doublings, which keeps the projective words)
template <class C>
__device__ __forceinline__ Pt<C> combine_windows(const PointPtrs& wins,
                                                 size_t stride, size_t at,
                                                 int num_win, int c) {
  Pt<C> acc;
  coord_zero(acc.x);
  coord_one(acc.y);
  coord_zero(acc.z);
#pragma unroll 1
  for (int j = num_win - 1; j >= 0; j--) {
#pragma unroll 1
    for (int k = 0; k < c; k++) acc = lanes::pt_double(acc);
    acc = lanes::pt_add(acc, lanes::load_point<C>(wins, stride, at + j));
  }
  return acc;
}

}  // namespace lanes
