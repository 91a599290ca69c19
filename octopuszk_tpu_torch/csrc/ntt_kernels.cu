// The NTT as sub-transforms in shared memory: ntt_block, every radix-2
// stage of a batch of transforms of length L <= 2^12 in one launch.
//
// It replaces the stage-per-launch use of the TPU kernel
// octopuszk_tpu/ops/pallas_ops.py::butterfly (_butterfly_kernel), which
// ops/ntt.py of the reference calls once per stage of every transform
// (log2 n launches, the twiddle and coset tables rebuilt by mont_mul
// doubling steps on every call).  field_kernels.cu keeps that kernel as
// the reference's function.  ops/ntt.py cuts a transform of n > 2^12 into
// the 4-step's column and row sub-transforms, so a 2^20 transform is two
// launches: the twiddles omega^(k1 j2) ride the first launch as ``post``,
// the transpose rides the second launch's loads as strides, and the coset
// powers and the scale ride as ``pre`` / ``post``.
//
// One block owns one transform: it loads the L elements (strided as the
// view says, times ``pre``, bit-reversed for DIT), runs the log2 L stages
// between block barriers on the shared copy (8 words x L, word-major,
// padded: 33 L bytes, 132 KB at 2^12, so dynamic shared memory), and
// stores the result (bit-reversed for DIF, times ``post``) into the
// contiguous [8, L, batch] output.  The stage loop is ntt.cuh's, which the
// host tests run too.
//
// Bound on this card: integer multiply throughput, one Montgomery product
// per butterfly ((L/2) log2 L per transform) and one per pre / post
// element, against 64 bytes moved per element.  The column pass reads and
// writes with a stride of C elements, so each 4-byte word is its own
// sector; the neighbouring blocks, which run at the same time, use the
// rest of each sector from L2.  Blocks of 256 threads (fewer where L/2 is
// smaller), two butterflies a thread a stage at L = 2^10.
#include <cuda_runtime.h>
#include "ntt.cuh"
#include "curve.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxLog = 12;

template <class M, bool DIF>
__global__ void __launch_bounds__(kMaxThreads)
ntt_block_kernel(NttArgs a) {
  extern __shared__ uint32_t smem[];
  BlockSched sched;
  ntt_block_run<M, DIF>(a, smem, (long long)blockIdx.x, sched);
}

inline size_t smem_bytes(int log_l) {
  return (size_t)8 * ntt_smem_stride(1u << log_l) * sizeof(uint32_t);
}

constexpr int kMaxDevices = 64;

template <class M, bool DIF>
int launch(const NttArgs& a, cudaStream_t s) {
  // the largest transform's shared copy, allowed once per instance and
  // device (the attribute is the current device's)
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    e = cudaFuncSetAttribute(ntt_block_kernel<M, DIF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxLog));
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = true;
  }
  const int half = 1 << (a.log_l - 1);
  const int threads = half < kMaxThreads ? (half < 32 ? 32 : half)
                                         : kMaxThreads;
  ntt_block_kernel<M, DIF><<<(unsigned)a.batch, threads, smem_bytes(a.log_l),
                             s>>>(a);
  return (int)cudaGetLastError();
}

NttView view(const void* p, const long long* st) {
  return {(const uint32_t*)p, st[0], st[1], st[2], st[3]};
}

}  // namespace

// field: 0 = the unit's curve's Fr, 1 = its Fq (curve.cuh).  x, pre,
// post: the operands (pre, post may be null), each with four element
// strides (word, l, outer batch, inner batch) in ``strides`` (x, pre, post
// in turn); tw: [8, L/2]; out: [8, L, batch]; the batch entry b is (b /
// inner, b % inner).  Returns cudaGetLastError().
extern "C" int oz_ntt_block(int field, int dif, const void* x,
                            const void* pre, const void* post,
                            const long long* strides, const void* tw,
                            void* out, int log_l, long long batch,
                            long long inner, void* stream) {
  if (log_l < 1 || log_l > kMaxLog || batch <= 0 || inner <= 0 ||
      batch % inner != 0 || batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  NttArgs a;
  a.x = view(x, strides);
  a.pre = view(pre, strides + 4);
  a.post = view(post, strides + 8);
  a.tw = (const uint32_t*)tw;
  a.out = (uint32_t*)out;
  a.log_l = log_l;
  a.batch = batch;
  a.inner = inner;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return dif ? launch<CurveFr, true>(a, s) : launch<CurveFr, false>(a, s);
  return dif ? launch<CurveFq, true>(a, s) : launch<CurveFq, false>(a, s);
}
