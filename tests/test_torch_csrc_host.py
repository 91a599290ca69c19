"""The CUDA headers' arithmetic (csrc/field.cuh, fp2.cuh, rcb.cuh), compiled
for the host with the system's C++ compiler, against the plain PyTorch
versions of the kernels (ops/kernels.py ``*_plain``), bit for bit.

On the card the carry-chain steps of field.cuh are PTX instructions on the
carry flag; compiled for the host each step is its definition in C++ over
a flag variable (field.cuh, namespace ``cc``).  So this runs the same
sequence of steps (the Montgomery product's even/odd rounds, the chained
add, subtract and conditional subtract) and the same point formulas, term
for term, that the kernels run: what the card adds is the instruction
selection.  Both curves: BN254a and BN254b, whose Fp2 non-residue -5 and
G1 b3 = 39 take the headers' other branches; and the field arithmetic,
the chains and the transform under the test fields of no curve, SMALL (62
bits) and LARGE (255 bits, the widest modulus the headers take: field.cuh
argues p < 2^255).  Inputs: seeded random words below p, with 0, 1, p - 1,
p - 2 and 2^255 mod p among them; tolerance: exact."""

import ctypes
import random
import shutil
import subprocess

import pytest
import torch

from octopuszk_tpu_torch.curves import bn254
from octopuszk_tpu_torch.curves.family import bn254b
from octopuszk_tpu_torch.fields import spec as tspec
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints

torch.set_num_threads(1)

N = 64
# the harness's field and group ids (BN254a, then BN254b: u^2 = -5, b3 = 39;
# then the test fields)
FIELDS = {"fr": (0, tspec.FR), "fq": (1, tspec.FQ), "frb": (2, tspec.FR_B),
          "fqb": (3, tspec.FQ_B), "small": (4, tspec.SMALL),
          "large": (5, tspec.LARGE)}
GROUP_IDS = {"G1": 1, "G2": 2, "bn254b-G1": 3, "bn254b-G2": 4}


def _group(gname):
    return {"G1": bn254.G1, "G2": bn254.G2, "bn254b-G1": bn254b().g1,
            "bn254b-G2": bn254b().g2}[gname]

HARNESS = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include "lanes.cuh"
#include "ntt.cuh"

// A warp emulated by a loop over its 32 lanes, for lanes.cuh: each value
// holds every lane's, each operation runs lane by lane.
template <class T>
struct Lanes {
  T v[32];
  Lanes() = default;
  Lanes(T x) {
    for (int l = 0; l < 32; l++) v[l] = x;
  }
  template <class S>
  explicit Lanes(const Lanes<S>& o) {
    for (int l = 0; l < 32; l++) v[l] = (T)o.v[l];
  }
#define LANES_OP(R, op)                                      \
  friend R operator op(const Lanes& a, const Lanes& b) {     \
    R r;                                                     \
    for (int l = 0; l < 32; l++) r.v[l] = a.v[l] op b.v[l];  \
    return r;                                                \
  }
  LANES_OP(Lanes, +) LANES_OP(Lanes, -) LANES_OP(Lanes, *)
  LANES_OP(Lanes, &) LANES_OP(Lanes, |) LANES_OP(Lanes, ^)
  LANES_OP(Lanes, <<) LANES_OP(Lanes, >>)
  LANES_OP(Lanes<bool>, ==) LANES_OP(Lanes<bool>, !=) LANES_OP(Lanes<bool>, <)
#undef LANES_OP
  friend Lanes sel(const Lanes<bool>& c, const Lanes& a, const Lanes& b) {
    Lanes r;
    for (int l = 0; l < 32; l++) r.v[l] = c.v[l] ? a.v[l] : b.v[l];
    return r;
  }
};

struct HostLanes {
  typedef Lanes<uint32_t> U32;
  typedef Lanes<uint64_t> U64;
  typedef Lanes<bool> Pred;
  static U32 lane() {
    U32 r;
    for (int l = 0; l < 32; l++) r.v[l] = l;
    return r;
  }
  static U32 shfl(const U32& v, const U32& src) {
    U32 r;
    for (int l = 0; l < 32; l++) r.v[l] = v.v[src.v[l] & 31u];
    return r;
  }
  static uint32_t ballot(const Pred& p) {
    uint32_t m = 0;
    for (int l = 0; l < 32; l++) m |= (uint32_t)p.v[l] << l;
    return m;
  }
  static U32 load(const uint32_t* base, size_t stride, size_t i,
                  const U32& k) {
    U32 r;
    for (int l = 0; l < 32; l++) r.v[l] = base[k.v[l] * stride + i];
    return r;
  }
  static void store(uint32_t* base, size_t stride, size_t i, const U32& k,
                    const U32& v, const Pred& on) {
    for (int l = 0; l < 32; l++)
      if (on.v[l]) base[k.v[l] * stride + i] = v.v[l];
  }
};

// field ids: 0 BN254a Fr, 1 BN254a Fq, 2 BN254b Fr, 3 BN254b Fq, 4 SMALL,
// 5 LARGE; fn is called with a value of the modulus type
template <class Fn>
static void with_field(int field, Fn fn) {
  switch (field) {
    case 0: fn(FrMod{}); break;
    case 1: fn(FqMod{}); break;
    case 2: fn(FrbMod{}); break;
    case 3: fn(FqbMod{}); break;
    case 4: fn(SmallMod{}); break;
    default: fn(LargeMod{}); break;
  }
}

// group ids: 1 BN254a G1, 2 BN254a G2, 3 BN254b G1, 4 BN254b G2; fn is
// called with a value of the coordinate type
template <class Fn>
static void with_group(int group, Fn fn) {
  switch (group) {
    case 1: fn(Fp<FqMod>{}); break;
    case 2: fn(Fp2<FqMod>{}); break;
    case 3: fn(Fp<FqbMod>{}); break;
    default: fn(Fp2<FqbMod>{}); break;
  }
}

static int coord_dim(int group) { return group % 2 ? 1 : 2; }

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

// op: 0 mul, 1 add, 2 sub, 3 neg (of a)
extern "C" void field_op(int field, int op, const uint32_t* a,
                         const uint32_t* b, uint32_t* out, long n) {
  with_field(field, [&](auto m) { binary<decltype(m)>(op, a, b, out, n); });
}

// lanes.cuh's product, add and subtract (op 0, 1, 2) on emulated warps,
// four elements a warp: element i + g on group g (n: a multiple of 4)
template <class M>
static void lanes_binary(int op, const uint32_t* a, const uint32_t* b,
                         uint32_t* out, long n) {
  typedef lanes::LFp<M, HostLanes> E;
  for (long i = 0; i < n; i += 4) {
    E x, y, r;
    for (int l = 0; l < 32; l++) {
      x.w.v[l] = a[(l & 7) * n + i + (l >> 3)];
      y.w.v[l] = b[(l & 7) * n + i + (l >> 3)];
    }
    if (op == 0) r.w = lanes::mont_mul<M, HostLanes>(x.w, y.w);
    else if (op == 1) r = lanes::add(x, y);
    else r = lanes::sub(x, y);
    for (int l = 0; l < 32; l++) out[(l & 7) * n + i + (l >> 3)] = r.w.v[l];
  }
}

extern "C" void lanes_field_op(int field, int op, const uint32_t* a,
                               const uint32_t* b, uint32_t* out, long n) {
  with_field(field, [&](auto m) {
    lanes_binary<decltype(m)>(op, a, b, out, n);
  });
}

template <class M>
static void load(Fp<M>& c, uint32_t* const* p, int ci, long n, long i) {
  c = fp_load<M>(p[ci], n, i);
}
template <class M>
static void load(Fp2<M>& c, uint32_t* const* p, int ci, long n, long i) {
  c.c0 = fp_load<M>(p[2 * ci], n, i);
  c.c1 = fp_load<M>(p[2 * ci + 1], n, i);
}
template <class M>
static void store(const Fp<M>& c, uint32_t* const* p, int ci, long n,
                  long i) {
  fp_store<M>(p[ci], n, i, c);
}
template <class M>
static void store(const Fp2<M>& c, uint32_t* const* p, int ci, long n,
                  long i) {
  fp_store<M>(p[2 * ci], n, i, c.c0);
  fp_store<M>(p[2 * ci + 1], n, i, c.c1);
}

// op: 0 add (p + q), 1 double (p), 2 mixed add (p + (q.x, q.y)), 3 b3
// times p.x; the components of each point: 3 (G1) or 6 (G2) word-major
// [8, n] arrays
template <class C>
static void points(int op, uint32_t* const* p, uint32_t* const* q,
                   uint32_t* const* out, long n) {
  for (long i = 0; i < n; i++) {
    Pt<C> a, b, r;
    load(a.x, p, 0, n, i); load(a.y, p, 1, n, i); load(a.z, p, 2, n, i);
    load(b.x, q, 0, n, i); load(b.y, q, 1, n, i); load(b.z, q, 2, n, i);
    if (op == 0) r = pt_add(a, b);
    else if (op == 1) r = pt_double(a);
    else if (op == 2) r = pt_mixed_add(a, b.x, b.y);
    else r = {mul_b3(a.x), a.y, a.z};
    store(r.x, out, 0, n, i); store(r.y, out, 1, n, i);
    store(r.z, out, 2, n, i);
  }
}

static PointPtrs ptrs(uint32_t* const* a, int group);

// lanes.cuh's add (op 4) and double (op 5), one emulated warp a point
template <class C>
static void lanes_points(int op, int group, uint32_t* const* p,
                         uint32_t* const* q, uint32_t* const* out, long n) {
  typedef typename lanes::Spread<C, HostLanes>::type S;
  const PointPtrs pp = ptrs(p, group), pq = ptrs(q, group),
                  po = ptrs(out, group);
  for (long i = 0; i < n; i++) {
    const Pt<S> a = lanes::load_point<S>(pp, n, i);
    lanes::store_point(op == 4 ? lanes::pt_add(a, lanes::load_point<S>(pq, n, i))
                               : lanes::pt_double(a),
                       po, n, i);
  }
}

extern "C" void point_op(int group, int op, uint32_t* const* p,
                         uint32_t* const* q, uint32_t* const* out, long n) {
  with_group(group, [&](auto c) {
    if (op >= 4) lanes_points<decltype(c)>(op, group, p, q, out, n);
    else points<decltype(c)>(op, p, q, out, n);
  });
}

// --- the chains that run as one launch each, every thread's work in turn

static Exponent exponent(const uint32_t* e, int top) {
  Exponent x;
  for (int k = 0; k < 8; k++) x.w[k] = e[k];
  x.top = top;
  return x;
}

template <class M>
static void pow_all(const uint32_t* a, uint32_t* out, long n,
                    const Exponent& e) {
  for (long i = 0; i < n; i++)
    fp_store<M>(out, n, i, pow_exp(fp_load<M>(a, n, i), e));
}

extern "C" void pow_op(int field, const uint32_t* a, uint32_t* out, long n,
                       const uint32_t* e, int top) {
  with_field(field, [&](auto m) {
    pow_all<decltype(m)>(a, out, n, exponent(e, top));
  });
}

// a vote that never ends the divstep loop early: every batch runs, as on
// a lane of a warp whose other lanes still need them
struct NoExit {
  static bool all(bool) { return false; }
};

// the safegcd inversion of each element (vote: 0 the element alone, 1 all
// 20 batches)
template <class M, class V>
static void inv_all(const uint32_t* a, uint32_t* out, long n) {
  for (long i = 0; i < n; i++)
    fp_store<M>(out, n, i, inv_safegcd<M, V>(fp_load<M>(a, n, i)));
}

extern "C" void inv_op(int field, int vote, const uint32_t* a,
                       uint32_t* out, long n) {
  with_field(field, [&](auto m) {
    if (vote) inv_all<decltype(m), NoExit>(a, out, n);
    else inv_all<decltype(m), OneThread>(a, out, n);
  });
}

template <class M>
static bool coord_equal(const Fp<M>& a, const Fp<M>& b) {
  for (int k = 0; k < 8; k++)
    if (a.v[k] != b.v[k]) return false;
  return true;
}
template <class M>
static bool coord_equal(const Fp2<M>& a, const Fp2<M>& b) {
  return coord_equal(a.c0, b.c0) && coord_equal(a.c1, b.c1);
}
// both threads of a pair hold the sum
template <class C>
static bool pt_equal(const Pt<C>& a, const Pt<C>& b) {
  return coord_equal(a.x, b.x) && coord_equal(a.y, b.y) &&
         coord_equal(a.z, b.z);
}

static PointPtrs ptrs(uint32_t* const* a, int group) {
  PointPtrs p;
  for (int k = 0; k < 6; k++)
    p.c[k] = k < 3 * coord_dim(group) ? a[k] : nullptr;
  return p;
}

// The threads of a block as host threads that meet at every barrier.
struct HostBarrier {
  int parties;
  int arrived = 0;
  unsigned long phase = 0;
  std::mutex mu;
  std::condition_variable cv;
  void barrier() {
    std::unique_lock<std::mutex> lk(mu);
    const unsigned long ph = phase;
    if (++arrived == parties) {
      arrived = 0;
      phase++;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return phase != ph; });
    }
  }
};

// The two threads of a pair (rcb.cuh pt_add_pair) as two host threads
// that meet at every exchange: each writes its value to its pair's slots,
// waits for the other, reads the other's and waits again before the
// slots are reused.  A host thread names its half (``me``) and its pair's
// slots (``at``), so several pairs can run at once.
struct PairSlots {
  uint32_t v[2][8];
  HostBarrier meet{2};
};

struct HostPair {
  static thread_local int me;
  static thread_local PairSlots* at;
  template <int W>
  static void swap_words(const uint32_t* mine, uint32_t* theirs) {
    for (int k = 0; k < W; k++) at->v[me][k] = mine[k];
    at->meet.barrier();
    for (int k = 0; k < W; k++) theirs[k] = at->v[1 - me][k];
    at->meet.barrier();
  }
  template <class M>
  static Fp<M> other(const Fp<M>& a) {
    Fp<M> r;
    swap_words<8>(a.v, r.v);
    return r;
  }
  template <class M>
  static Fp2<M> other(const Fp2<M>& a) {
    return {other(a.c0), other(a.c1)};
  }
};
thread_local int HostPair::me = 0;
thread_local PairSlots* HostPair::at = nullptr;

// the two halves of pair work fn(h) on two host threads
template <class Fn>
static void run_pair(Fn fn) {
  PairSlots slots;
  auto half = [&](int h) {
    HostPair::me = h;
    HostPair::at = &slots;
    fn(h);
  };
  std::thread other(half, 1);
  half(0);
  other.join();
}

// one thread: every item of a level in order, no barrier needed; one block
// of one thread
struct HostSched {
  ItemRange range(size_t rows, size_t per_row) const {
    return {0, 1, rows * per_row};
  }
  void barrier() {}
  ItemRange blocks(size_t n) const { return {0, 1, n}; }
  ItemRange threads(size_t n) const { return {0, 1, n}; }
  void sync() {}
};

// op: 0 window table (a = base, b = powers, n = npow, x = w, y = outerc,
// batch = the rounds run per window before the grid's), 1 lane row sums
// (a = points [batch, n], x = width; the two threads of a pair as two host
// threads; a lane whose halves differ is stored as zeros), 4 combine (a =
// window results [batch, n], x = c; one emulated warp per row), 5
// doubling chain (a = points [n], x = times, y = every_step; one emulated
// warp per point)
template <class C>
static void chain(int op, int group, uint32_t* const* a, uint32_t* const* b,
                  uint32_t* const* out, long batch, long n, int x, int y) {
  const PointPtrs pa = ptrs(a, group), po = ptrs(out, group);
  HostSched sched;
  if (op == 0) {
    window_table_rounds<C>(pa, ptrs(b, group), n, x, y, po, (int)batch,
                           sched);
  } else if (op == 1) {
    const size_t rows = (n + x - 1) / x;
    for (long i = 0; i < batch * x; i++) {
      Pt<C> acc[2];
      run_pair([&](int h) {
        acc[h] = lane_row_sum_pair<C, HostPair>(pa, batch * n, (i / x) * n,
                                                n, i % x, rows, h != 0);
      });
      store_point(acc[0], po, batch * x, i);
      if (!pt_equal(acc[0], acc[1])) store_point(Pt<C>{}, po, batch * x, i);
    }
  } else if (op == 4) {
    typedef typename lanes::Spread<C, HostLanes>::type S;
    for (long i = 0; i < batch; i++)
      lanes::store_point(
          lanes::combine_windows<S>(pa, batch * n, i * n, (int)n, x), po,
          batch, i);
  } else {
    typedef typename lanes::Spread<C, HostLanes>::type S;
    for (long i = 0; i < n; i++)
      lanes::double_chain<S>(pa, po, n, i, x, y != 0);
  }
}

extern "C" void chain_op(int op, int group, uint32_t* const* a,
                         uint32_t* const* b, uint32_t* const* out, long batch,
                         long n, int x, int y) {
  with_group(group, [&](auto c) {
    chain<decltype(c)>(op, group, a, b, out, batch, n, x, y);
  });
}

// one thread: every item of a phase in order, no barrier needed
struct HostBlock {
  unsigned first() const { return 0; }
  unsigned step() const { return 1; }
  void barrier() {}
};

// tree_sum_block's barrier and count of arrivals for a block whose
// threads are host threads (``tid``: the calling thread's index)
struct HostTreeBlock {
  HostBarrier bar;
  bool flag = false;
  static thread_local unsigned tid;
  void sync() { bar.barrier(); }
  bool arrive(unsigned* c, unsigned groups) {
    bar.barrier();
    if (tid == 0) flag = ++*c == groups;
    bar.barrier();
    return flag;
  }
};
thread_local unsigned HostTreeBlock::tid = 0;

// the blocks of tree_sum_block<K> one after the other (``reverse``: last
// first, so the first group of a parent arrives last), each block's 2^K
// threads as host threads
template <class C, int K>
static void tree_blocks(int group, uint32_t* const* a, uint32_t* const* b,
                        uint32_t* const* out, long batch, long n,
                        bool reverse) {
  const TreeShape s = tree_shape<K>(batch, n);
  const int comps = 3 * coord_dim(group);
  const size_t nslots = (size_t)1 << (K - 1);
  std::vector<uint32_t> smem(comps * 8 * nslots);
  PointPtrs slots;
  for (int c = 0; c < 6; c++)
    slots.c[c] = c < comps ? smem.data() + c * 8 * nslots : nullptr;
  std::vector<unsigned> count(batch * ((n + 1) / 2), 0u);
  const PointPtrs pa = ptrs(a, group), pb = ptrs(b, group),
                  po = ptrs(out, group);
  for (size_t k = 0; k < s.blocks; k++) {
    const size_t blk = reverse ? s.blocks - 1 - k : k;
    HostTreeBlock sched{HostBarrier{1 << K}};
    std::unique_ptr<PairSlots[]> pairs(new PairSlots[1 << (K - 1)]);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (1u << K); t++)
      threads.emplace_back([&, t] {
        HostPair::me = t & 1;
        HostPair::at = &pairs[t >> 1];
        HostTreeBlock::tid = t;
        tree_sum_block<C, HostPair, K>(pa, pb, po, batch, n, blk, t, slots,
                                       count.data(), sched);
      });
    for (std::thread& th : threads) th.join();
  }
}

// the pairwise tree over each row of a = points [batch, n] (b: scratch
// shaped as a, out: [batch]) in tiers of 2^k, k = 2 or the kernel's
extern "C" void tree_op(int group, int k, int reverse, uint32_t* const* a,
                        uint32_t* const* b, uint32_t* const* out, long batch,
                        long n) {
  with_group(group, [&](auto c) {
    if (k == 2)
      tree_blocks<decltype(c), 2>(group, a, b, out, batch, n, reverse != 0);
    else
      tree_blocks<decltype(c), kTreeLog>(group, a, b, out, batch, n,
                                         reverse != 0);
  });
}

extern "C" int tree_log() { return kTreeLog; }

// prefix_sum_item's barrier, count of arrivals and wait for a block whose
// threads are host threads (``tid``: the calling thread's index); a wait
// on a row whose tiles have not all arrived (an item run before a tile it
// needs) sets ``bad`` and goes on
struct HostPrefixBlock {
  HostBarrier bar;
  bool bad = false;
  static thread_local unsigned tid;
  void sync() { bar.barrier(); }
  void arrive(unsigned* c, unsigned first, unsigned last) {
    bar.barrier();
    if (tid == 0)
      for (unsigned b = first; b <= last; b++) c[b]++;
  }
  void wait(const unsigned* c, unsigned target) {
    if (tid == 0 && *c != target) bad = true;
    bar.barrier();
  }
};
thread_local unsigned HostPrefixBlock::tid = 0;

// the items of prefix_sum_item (classes mod 2^m, T threads a worker,
// blocks of B threads, R rounds of workers a tile's first level, buffers
// of S slots, identity adds by ID, as prefix.cuh launches them) one after
// the other, each on B host threads: the tiles, then the classes, each
// phase in order or (``reverse``) last first.  Returns 1 if an item
// waited on a row whose tiles had not all arrived.
template <class C, int T, int B, int R, int S, bool ID>
static int prefix_items(int group, int m, uint32_t* const* a,
                        uint32_t* const* out, long batch, long n,
                        bool reverse) {
  const PrefixShape s = prefix_shape(batch, n, m, B / T, R, S);
  std::vector<uint32_t> smem(2 * 3 * coord_dim(group) * 8 * S);
  std::vector<unsigned> count(batch, 0u);
  const PointPtrs pa = ptrs(a, group), po = ptrs(out, group);
  int bad = 0;
  for (size_t k = 0; k < s.items; k++) {
    const size_t item = !reverse ? k
                        : k < s.tiles ? s.tiles - 1 - k
                                      : s.tiles + s.items - 1 - k;
    HostPrefixBlock sched{HostBarrier{B}};
    std::unique_ptr<PairSlots[]> pairs(new PairSlots[B / 2 + 1]);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (unsigned)B; t++)
      threads.emplace_back([&, t] {
        HostPair::me = t & 1;
        HostPair::at = &pairs[t >> 1];
        HostPrefixBlock::tid = t;
        prefix_sum_item<C, HostPair, T, S, ID>(pa, po, s, item, t, B,
                                               smem.data(), count.data(),
                                               sched);
      });
    for (std::thread& th : threads) th.join();
    bad |= sched.bad;
  }
  return bad;
}

// the prefix over each row of a = points [batch, n] into out: ``own`` 0
// with classes mod 2^2 on blocks of 4 pairs (buffers of 9 slots), the adds
// of the identity by pt_add_identity; 1 as the library's kernel for the
// group (rcb.cuh PrefixConfig)
extern "C" int prefix_op(int group, int own, int reverse, uint32_t* const* a,
                         uint32_t* const* out, long batch, long n) {
  int bad = 0;
  with_group(group, [&](auto c) {
    typedef decltype(c) C;
    typedef PrefixOf<C> K;
    if (own)
      bad = prefix_items<C, K::kThreads, K::kBlock, K::kRounds, K::kSlots,
                         K::kIdentity>(group, K::kLog, a, out, batch, n,
                                       reverse != 0);
    else
      bad = prefix_items<C, 2, 8, 2, 9, true>(group, 2, a, out, batch, n,
                                              reverse != 0);
  });
  return bad;
}

// the library's class modulus (log2) for a group
extern "C" int prefix_log(int group) {
  int m = 0;
  with_group(group, [&](auto c) { m = PrefixOf<decltype(c)>::kLog; });
  return m;
}

// add_point_pair over a batch of n: the grid's threads 0 .. ``threads``
// (past 2 n: the warp's threads past the end) in pairs, one pair at a time
extern "C" void add_pair_op(int group, uint32_t* const* p,
                            uint32_t* const* q, uint32_t* const* out, long n,
                            long threads) {
  with_group(group, [&](auto c) {
    typedef decltype(c) C;
    const PointPtrs pp = ptrs(p, group), pq = ptrs(q, group),
                    po = ptrs(out, group);
    for (long t = 0; t < threads; t += 2)
      run_pair([&](int h) {
        add_point_pair<C, HostPair>(pp, pq, po, n, t + h);
      });
  });
}

// the batch inversion's blocks of T lanes (4 or the kernel's 128), one
// after the other, each on T host threads
template <class M, int T>
static void batch_inv_blocks(const uint32_t* a, uint32_t* out, long n,
                             long lanes) {
  std::vector<uint32_t> smem(batch_inv_smem_words(T));
  for (long b = 0; b * T < lanes; b++) {
    HostBarrier sync{T};
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (unsigned)T; t++)
      threads.emplace_back([&, t] {
        batch_inv_block<M, T>(a, out, n, lanes, b, t, smem.data(), sync);
      });
    for (std::thread& th : threads) th.join();
  }
}

extern "C" void batch_inv_op(int field, int threads, const uint32_t* a,
                             uint32_t* out, long n, long lanes) {
  with_field(field, [&](auto m) {
    if (threads == 4) batch_inv_blocks<decltype(m), 4>(a, out, n, lanes);
    else batch_inv_blocks<decltype(m), 128>(a, out, n, lanes);
  });
}

// the positions owned by the first ``threads`` lanes (n if each position
// has one owner and the threads past ``lanes`` own none)
extern "C" long batch_inv_owned(long n, long lanes, long threads) {
  long owned = 0;
  for (long l = 0; l < threads; l++) owned += batch_inv_rows_count(n, lanes, l);
  return owned;
}

template <class M, bool DIF>
static void ntt_all(const NttArgs& a) {
  std::vector<uint32_t> s(8 * ntt_smem_stride(1u << a.log_l));
  HostBlock sched;
  for (long long b = 0; b < a.batch; b++)
    ntt_block_run<M, DIF>(a, s.data(), b, sched);
}

static NttView view(const uint32_t* p, const long long* st) {
  return {p, st[0], st[1], st[2], st[3]};
}

// the transforms of ntt_kernels.cu's blocks, one after the other; strides:
// x, pre, post (word, l, outer batch, inner batch) in turn
extern "C" void ntt_block_op(int field, int dif, const uint32_t* x,
                             const uint32_t* pre,
                             const uint32_t* post, const long long* st,
                             const uint32_t* tw, uint32_t* out, int log_l,
                             long long batch, long long inner) {
  NttArgs a;
  a.x = view(x, st);
  a.pre = view(pre, st + 4);
  a.post = view(post, st + 8);
  a.tw = tw;
  a.out = out;
  a.log_l = log_l;
  a.batch = batch;
  a.inner = inner;
  with_field(field, [&](auto m) {
    if (dif) ntt_all<decltype(m), true>(a);
    else ntt_all<decltype(m), false>(a);
  });
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
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
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


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_arithmetic(host_lib, field):
    fid, spec = FIELDS[field]
    a = _words(_field_values(spec.p, 1))
    b = _words(_field_values(spec.p, 2))
    b[:, :5] = a[:, :5]                          # equal operands
    from octopuszk_tpu_torch.fields import fp
    want = {0: kernels.mont_mul_plain(spec, a, b), 1: fp.add(spec, a, b),
            2: fp.sub(spec, a, b), 3: fp.neg(spec, a)}
    for op, w in want.items():
        out = torch.empty_like(a)
        host_lib.field_op(fid, op, _ptr(a), _ptr(b), _ptr(out),
                          ctypes.c_long(N))
        assert torch.equal(out, w), (field, op)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_lane_field_arithmetic(host_lib, field):
    """lanes.cuh's product, add and subtract, each element spread over the
    eight lanes of a group of an emulated warp and four elements a warp
    (the groups' carries resolved by ballot), on the edge words and on
    pairs whose carry or borrow lands on a word of p minus one or on all
    ones (a + b = p - 1 and p through a carry out of word 0, a - b
    borrowing through zero words)."""
    fid, spec = FIELDS[field]
    a = _words(_field_values(spec.p, 1))
    b = _words(_field_values(spec.p, 2))
    b[:, :5] = a[:, :5]
    p, p0 = spec.p, spec.p & 0xFFFFFFFF
    pairs = [(p - 2**32, 2**32 - 1), (p - 2**32, 2**32), (p - 1, 1),
             (p - p0 - 1, p0 + 1), (0, 1), (2**32, 1), (2**64, 2**64 - 1)]
    a[:, 5:12] = _words([x for x, _ in pairs])
    b[:, 5:12] = _words([y for _, y in pairs])
    from octopuszk_tpu_torch.fields import fp
    want = {0: kernels.mont_mul_plain(spec, a, b), 1: fp.add(spec, a, b),
            2: fp.sub(spec, a, b)}
    for op, w in want.items():
        out = torch.empty_like(a)
        host_lib.lanes_field_op(fid, op, _ptr(a), _ptr(b), _ptr(out),
                                ctypes.c_long(N))
        assert torch.equal(out, w), (field, op)


def _flat(p):
    out = []
    for c in p:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


@pytest.mark.parametrize("gname", sorted(GROUP_IDS))
def test_point_formulas(host_lib, gname):
    """Full add, double and mixed add (the scans' step, in the order of
    rcb.cuh), the product by b3, and lanes.cuh's add and double (one
    emulated warp a point, a formula's products on its four groups) on
    points of the curve with the identity, equal and inverse pairs among
    them, and on random field elements off the curve (the formulas are
    polynomials)."""
    from octopuszk_tpu_torch.curves import group_ops
    g = _group(gname)
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
        [_words([rng.randrange(g.fq.p) for _ in range(N)])
         for _ in range(3 * cd)], cd) for _ in range(2))
    ops = kernels.plain_ops(gname)
    for p, q in (on_curve, off):
        x2, y2 = q[0], q[1]
        want = {0: kernels.add_points_plain(gname, p, q),
                1: kernels.double_points_plain(gname, p),
                2: group_ops.mixed_add(ops, p, (x2, y2)),
                3: (ops.mul_b3(p[0]), p[1], p[2])}
        want[4], want[5] = want[0], want[1]
        fp_, fq_ = _flat(p), _flat(q)
        for op, w in want.items():
            outs = [torch.empty_like(t) for t in fp_]
            host_lib.point_op(GROUP_IDS[gname], op, _ptrs(fp_), _ptrs(fq_),
                              _ptrs(outs), ctypes.c_long(N))
            for got, ref in zip(outs, _flat(w)):
                assert torch.equal(got, ref), (gname, op)


def _exponent(e):
    return (ctypes.c_uint32 * 8)(*[(e >> (32 * k)) & 0xFFFFFFFF
                                   for k in range(8)]), e.bit_length() - 1


def _batch_inv(host_lib, fid, a, lanes, threads=128):
    """The batch inversion over ``lanes`` in blocks of ``threads`` lanes
    (the kernel's 128, or 4: several blocks at these sizes); each
    position must have one owner among the grid's threads, and the
    threads past the last lane none."""
    out = torch.empty_like(a)
    n = a.shape[1]
    host_lib.batch_inv_owned.restype = ctypes.c_long
    grid = -(-lanes // threads) * threads
    assert host_lib.batch_inv_owned(ctypes.c_long(n), ctypes.c_long(lanes),
                                    ctypes.c_long(grid)) == n, lanes
    host_lib.batch_inv_op(fid, threads, _ptr(a), _ptr(out), ctypes.c_long(n),
                          ctypes.c_long(lanes))
    return out


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_chains(host_lib, field):
    """The square-and-multiply chain (q - 2, r - 2, short exponents, 0) and
    the batch inversion's lane sweeps (interleaved lanes, zeros among the
    inputs, n not a multiple of the lane count) against the plain
    versions."""
    fid, spec = FIELDS[field]
    a = _words(_field_values(spec.p, 4)[:37])
    for e in (spec.p_minus_2, 0b1011001, 1, 0):
        out = torch.empty_like(a)
        words, top = _exponent(e)
        host_lib.pow_op(fid, _ptr(a), _ptr(out),
                        ctypes.c_long(37), words, top)
        assert torch.equal(out, kernels.mont_pow_plain(spec, a, e)), e
    for lanes in (8, 37, 1):
        out = _batch_inv(host_lib, fid, a, lanes)
        assert torch.equal(out, kernels.batch_inv_rows_plain(spec, a, 5)), lanes
        out = _batch_inv(host_lib, fid, a, lanes, threads=4)
        assert torch.equal(out, kernels.batch_inv_rows_plain(spec, a, 5)), lanes


def _inversion_values(p):
    """Edge words: 0, 1, 2, p - 1, p - 2, 2^255 mod p, powers of two,
    values with long runs of zero bits (two set bits far apart, a low and
    a high run of ones), then seeded random words below p."""
    bits = p.bit_length()
    vals = [0, 1, 2, p - 1, p - 2, (1 << 255) % p]
    vals += [1 << k for k in range(1, bits - 1, 11)]
    vals += [(1 << (bits - 2)) + 1, (1 << (bits - 2)) + (1 << 3),
             (1 << 40) - 1, ((1 << 30) - 1) << (bits - 32),
             p - (1 << (bits // 2)),
             p >> 1]
    rng = random.Random(9)
    vals += [rng.randrange(p) for _ in range(N - len(vals))]
    return vals


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_safegcd_inversion(host_lib, field):
    """field.cuh's safegcd inversion (inv_safegcd) and the batch
    inversion's lane sweeps built on it, against the plain Fermat chain
    (mont_pow_plain of p - 2) and python's pow(x, -1, p) on the values of
    the words (Montgomery: the inverse of a R is a^-1 R); zero gives zero.
    The inversion ends its divstep loop when g is zero (vote 0) or runs
    all 20 batches, as a lane whose warp still needs them (vote 1): the
    same words.  The batch inversion (field.cuh batch_inv_block: lane
    sweeps, the block's lane totals multiplied, one inversion a block; a
    block's threads as host threads meeting at its barriers) at 1, 8 and
    37 lanes of 64 words with zeros among them, in blocks of the kernel's
    128 lanes and of 4 (up to ten blocks), the threads past the last lane
    owning nothing."""
    fid, spec = FIELDS[field]
    p = spec.p
    vals = _inversion_values(p)
    a = _words(vals)
    want = kernels.mont_pow_plain(spec, a, spec.p_minus_2)
    r2 = pow(1 << 256, 2, p)
    assert words_to_ints(want.numpy()) == [pow(v, -1, p) * r2 % p if v else 0
                                    for v in vals]
    for vote in (0, 1):
        out = torch.empty_like(a)
        host_lib.inv_op(fid, vote, _ptr(a), _ptr(out), ctypes.c_long(N))
        assert torch.equal(out, want), vote
    b = a.clone()
    b[:, 1::9] = 0
    want_b = torch.where((b == 0).all(0), torch.zeros_like(want), want)
    for lanes in (1, 8, 37):
        for threads in (128, 4):
            assert torch.equal(_batch_inv(host_lib, fid, b, lanes, threads),
                               want_b), (lanes, threads)


def _chain(host_lib, op, gname, a, b, out_shape, batch, n, x=0, y=0):
    fa = _flat(a)
    fb = _flat(b) if b is not None else fa
    outs = [torch.empty(out_shape, dtype=torch.int32) for _ in fa]
    host_lib.chain_op(op, GROUP_IDS[gname], _ptrs(fa), _ptrs(fb),
                      _ptrs(outs), ctypes.c_long(batch), ctypes.c_long(n),
                      x, y)
    return outs


def _tree(host_lib, gname, pts, batch, n, k, reverse=False):
    """rcb.cuh tree_sum_block over rows [batch, n] in tiers of 2^k, its
    blocks in turn (``reverse``: last first), each block's threads as host
    threads and its pairs exchanging through ``HostPair``."""
    fa = _flat(pts)
    scratch = [torch.empty_like(t) for t in fa]
    outs = [torch.empty((8, batch), dtype=torch.int32) for _ in fa]
    host_lib.tree_op(GROUP_IDS[gname], k, int(reverse), _ptrs(fa),
                     _ptrs(scratch), _ptrs(outs), ctypes.c_long(batch),
                     ctypes.c_long(n))
    return outs


def _prefix(host_lib, gname, pts, batch, n, own, reverse=False):
    """rcb.cuh prefix_sum_item over rows [batch, n]: its items on emulated
    blocks, tiles then classes, each phase in order or last first
    (``reverse``), classes mod 2^2 on blocks of 4 pairs (``own`` False) or
    as the library's kernel."""
    fa = _flat(pts)
    outs = [torch.zeros_like(t) for t in fa]
    bad = host_lib.prefix_op(GROUP_IDS[gname], int(own), int(reverse),
                             _ptrs(fa), _ptrs(outs), ctypes.c_long(batch),
                             ctypes.c_long(n))
    assert bad == 0, "an item ran before a tile of its row"
    return outs


@pytest.mark.parametrize("gname", sorted(GROUP_IDS))
def test_point_chains(host_lib, gname):
    """The window table round by round (every round across the grid, two
    on one block first, all on one block), the lane row sums, the pairwise
    tree on emulated blocks in tiers of 2^2 and of the kernel's 2^7 leaves
    (with its adds of the identity at n = 13, none at n = 8, a copy at n =
    1), the Hillis-Steele prefix in its two phases on emulated blocks
    (classes mod 2^2: tiles crossing rows at n = 13 and 8, a copy at n =
    1) and the window combine on emulated warps (two rows), against the
    plain versions' loops."""
    from octopuszk_tpu_torch.curves import group_ops
    g = _group(gname)
    rng = random.Random(5)
    host = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))
            for _ in range(26)]
    host[3] = None
    pts = g.points_to_device(host, "cpu")
    rows = group_ops._map_coords(pts, lambda c: c.reshape(8, 2, 13)
                                 .contiguous())

    w, outerc = 3, 3
    base = g.points_to_device(host[:1], "cpu")
    powers = kernels.double_points_plain(gname, base, outerc * w, True)
    powers = group_ops._map_coords(powers, lambda c: c[:, 0].contiguous())
    want = kernels.window_table_plain(gname, base, powers, w, outerc)
    for block_rounds in (0, 2, w):
        got = _chain(host_lib, 0, gname, base, powers, (8, outerc, 1 << w),
                     block_rounds, outerc * w, w, outerc)
        assert all(torch.equal(x, y) for x, y in zip(got, _flat(want))), \
            block_rounds

    got = _chain(host_lib, 1, gname, rows, None, (8, 2, 4), 2, 13, 4)
    want = kernels.lane_row_sums_plain(gname, rows, 4)
    assert all(torch.equal(x, y) for x, y in zip(got, _flat(want)))

    for n in (13, 8, 1):
        sub = group_ops._map_coords(rows, lambda c: c[..., :n].contiguous())
        want = kernels.tree_sum_plain(gname, sub)
        for k in (2, host_lib.tree_log()):
            got = _tree(host_lib, gname, sub, 2, n, k)
            assert all(torch.equal(x, y)
                       for x, y in zip(got, _flat(want))), (n, k)
        got = _prefix(host_lib, gname, sub, 2, n, False)
        want = kernels.prefix_sum_plain(gname, sub)
        assert all(torch.equal(x, y) for x, y in zip(got, _flat(want))), n

    wins = group_ops._map_coords(rows, lambda c: c[..., :4].contiguous())
    got = _chain(host_lib, 4, gname, wins, None, (8, 2), 2, 4, 5)
    want = kernels.combine_windows_plain(gname, wins, 5)
    assert all(torch.equal(x, y) for x, y in zip(got, _flat(want)))


@pytest.mark.parametrize("kind", ["double_chain", "row_sums", "tree",
                                  "pair_add", "prefix"])
@pytest.mark.parametrize("gname", sorted(GROUP_IDS))
def test_warp_chains(host_lib, gname, kind):
    """Kernel (e)'s doubling chain on one emulated warp per point (times =
    1, 4 and the Abel sum's 17, every step kept and not; three points, the
    identity among them); the row loop of ``lane_row_sums`` (two batch
    rows of n = 11 in 4 lanes of 3 rows, so the last lane adds the
    identity; an identity point, and a point followed by its inverse so a
    lane's sum passes through the identity); the tree of ``tree_sum`` on
    emulated blocks (tiers of 2^2 at n = 2^2 + 5 and 2^4 + 5, three
    tiers, and of the kernel's 2^7 at n = 2^7 + 5, so a row spans two
    subtrees and the last adds the identity; batch 1 and 2; blocks in
    order and last first); kernel (d)'s G2 add on two threads a point
    (``add_point_pair``: 20 points, the identity, P + P and P + (-P) among
    them, and the warp's threads past the end); and the prefix of
    ``prefix_sum`` in its two phases on emulated blocks, tiles then
    classes, each phase in order and last first (classes mod 2^2 on blocks
    of 4 pairs and as the library's kernel; n = 1, 4, 8, 13, 2^m - 1, 2^m
    + 3, 2^(m+2) + 5, so phase 1 alone, tiles crossing rows, a row's tail,
    classes of two lengths, a phase 2 of one level (in place on the
    output) and of three (in the buffers); with m = 2 also n = 41, whose
    classes of 11 exceed the 9 slots and run on the output in place; batch
    1 and 2), against the plain versions."""
    from octopuszk_tpu_torch.curves import group_ops
    g = _group(gname)
    rng = random.Random(6)
    if kind in ("tree", "pair_add", "prefix"):
        host = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))
                for _ in range(20)]
        host[3] = None
        host[7] = g.host.neg(host[6])
    if kind == "tree":
        k_kernel = host_lib.tree_log()
        for k, n in ((2, 9), (2, 21), (k_kernel, (1 << k_kernel) + 5)):
            for batch in (1, 2):
                leaves = (host * (-(-batch * n // len(host))))[:batch * n]
                pts = group_ops._map_coords(
                    g.points_to_device(leaves, "cpu"),
                    lambda c: c.reshape(8, batch, n).contiguous())
                want = _flat(kernels.tree_sum_plain(gname, pts))
                for reverse in (False, True):
                    got = _tree(host_lib, gname, pts, batch, n, k, reverse)
                    assert all(torch.equal(x, y) for x, y in zip(got, want)), \
                        (k, n, batch, reverse)
    elif kind == "prefix":
        for own in (False, True):
            m = host_lib.prefix_log(GROUP_IDS[gname]) if own else 2
            ns = [1, 4, 8, 13, (1 << m) - 1, (1 << m) + 3,
                  (4 << m) + 5] + ([] if own else [41])
            for n in ns:
                for batch in (1, 2):
                    pts = group_ops._map_coords(
                        g.points_to_device((host * 7)[:batch * n], "cpu"),
                        lambda c: c.reshape(8, batch, n).contiguous())
                    want = _flat(kernels.prefix_sum_plain(gname, pts))
                    for reverse in (False, True):
                        got = _prefix(host_lib, gname, pts, batch, n, own,
                                      reverse)
                        assert all(torch.equal(x, y)
                                   for x, y in zip(got, want)), \
                            (own, n, batch, reverse)
    elif kind == "pair_add":
        qs = [host[(i + 5) % 20] for i in range(20)]
        qs[1] = host[1]                            # P + P
        qs[2] = g.host.neg(host[2])                # P + (-P)
        qs[4] = None                               # P + 0
        p = g.points_to_device(host, "cpu")
        q = g.points_to_device(qs, "cpu")
        want = _flat(kernels.add_points_plain(gname, p, q))
        fp_, fq_ = _flat(p), _flat(q)
        outs = [torch.zeros_like(t) for t in fp_]
        host_lib.add_pair_op(GROUP_IDS[gname], _ptrs(fp_), _ptrs(fq_),
                             _ptrs(outs), ctypes.c_long(20),
                             ctypes.c_long(64))
        assert all(torch.equal(x, y) for x, y in zip(outs, want))
    elif kind == "double_chain":
        host = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64)),
                None,
                g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))]
        pts = g.points_to_device(host, "cpu")
        for times in (1, 4, 17):
            steps = kernels.double_points_plain(gname, pts, times, True)
            last = group_ops._map_coords(steps, lambda c: c[..., -1])
            for every, want in ((True, steps), (False, last)):
                got = _chain(host_lib, 5, gname, pts, None,
                             (8, 3, times) if every else (8, 3), 1, 3,
                             times, int(every))
                assert all(torch.equal(x, y)
                           for x, y in zip(got, _flat(want))), (times, every)
    else:
        host = [g.host.mul(g.generator_affine, rng.randrange(1, 1 << 64))
                for _ in range(22)]
        host[4] = None
        host[7] = g.host.neg(host[6])
        rows = group_ops._map_coords(g.points_to_device(host, "cpu"),
                                     lambda c: c.reshape(8, 2, 11)
                                     .contiguous())
        got = _chain(host_lib, 1, gname, rows, None, (8, 2, 4), 2, 11, 4)
        want = kernels.lane_row_sums_plain(gname, rows, 4)
        assert all(torch.equal(x, y) for x, y in zip(got, _flat(want)))


@pytest.mark.parametrize("log_l", [6, 5])
@pytest.mark.parametrize("dif", [True, False])
def test_ntt_block_stages(host_lib, dif, log_l):
    """ntt.cuh's transform (load with ``pre`` and, for DIT, the bit
    reversal; the stages; store with the bit reversal for DIF and ``post``)
    at L = 64 and 32 over Fr, one transform after another as the kernel's
    blocks run them: a batch of 2 x 3 read through a transposed view, with
    a ``pre`` table broadcast over the inner batch and a full ``post``
    table, and without tables, against ntt_block_plain."""
    _check_ntt_block(host_lib, "fr", dif, log_l)


@pytest.mark.parametrize("dif", [True, False])
def test_ntt_block_stages_small_field(host_lib, dif):
    """The same transform at L = 32 over the 62-bit test field SMALL."""
    _check_ntt_block(host_lib, "small", dif, 5)


def _check_ntt_block(host_lib, field, dif, log_l):
    from octopuszk_tpu_torch.ops import ntt
    fid, spec = FIELDS[field]
    L, b1, b2 = 1 << log_l, 2, 3
    rng = random.Random(7)

    def field(*shape):
        cnt = 1
        for d in shape:
            cnt *= d
        vals = [rng.randrange(spec.p) for _ in range(cnt)]
        vals[:3] = [0, 1, spec.p - 1]
        return _words(vals).reshape((8,) + shape)

    x = field(b1, L, b2).permute(0, 2, 1, 3)         # [8, L, b1, b2] view
    pre = field(L, b1, 1).expand(8, L, b1, b2)
    post = field(L, b1, b2)
    tw = ntt._stage_twiddles(spec, L, not dif, "cpu")
    for p_, q_ in ((pre, post), (None, None)):
        strides = []
        for t in (x, p_, q_):
            strides += [0] * 4 if t is None else list(t.stride())
        out = torch.empty((8, L, b1, b2), dtype=torch.int32)
        host_lib.ntt_block_op(
            fid, int(dif), _ptr(x), None if p_ is None else _ptr(p_),
            None if q_ is None else _ptr(q_),
            (ctypes.c_longlong * 12)(*strides), _ptr(tw), _ptr(out), log_l,
            ctypes.c_longlong(b1 * b2), ctypes.c_longlong(b2))
        want = kernels.ntt_block_plain(spec, x, tw, dif, p_, q_)
        assert torch.equal(out, want), (dif, p_ is None)
