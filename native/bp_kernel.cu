// Whole-decode belief-propagation kernel for the polar butterfly graph.
//
// One thread block owns F frames and keeps their complete message state,
// L and R on the (n+1) x N lattice (2 (n+1) N floats per frame, 90,112 B at
// N = 1024), in shared memory for every iteration.  Device memory is touched
// only to load the channel LLRs (or the wave state) and to store the
// decisions, so the kernel's traffic is ~5 KB per frame instead of the
// per-iteration state round trip of the plain XLA loop.
//
// Semantics are those of polardecoding_tpu/models/bp.py, operation for
// operation: an iteration is the R-sweep over stages 0..n-1 then the L-sweep
// over stages n-1..0 (Gauss-Seidel across stages, parallel within a stage),
// with the check-node update of ops/chk.py in the same association.  Every
// butterfly of a stage is independent, so a stage is one block-strided loop
// over F N/2 butterflies followed by a barrier.
//
// The same source builds two ways:
//   nvcc (default)       CUDA kernels behind XLA FFI handlers for the GPU;
//   c++ -DPD_HOST        the identical block bodies run serially on the host
//                        (a "block" is a loop over its threads; barriers are
//                        no-ops), behind XLA FFI handlers for the CPU, so the
//                        kernel's arithmetic and control flow are testable
//                        without a card.
// Nothing carries per-thread state across a barrier, which is what makes the
// serial host schedule equivalent to the parallel one.
//
// Entries:
//   pd_bp_decode  channel LLRs [B, N] -> decisions [B, N] int8, fixed
//                 iterations or the per-frame early-stop latch
//                 (bp_decode(early_stop_every=E)); a block returns as soon as
//                 all of its frames have latched, which changes no output.
//   pd_bp_wave    the fused wave step on the stage-major state [2(n+1), B, N]:
//                 refill-merge of retired slots, K iterations with the
//                 in-wave check latch, decide (bp_wave_fused_jnp).
#include <math.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

#ifdef PD_HOST
#include <vector>
#define PD_DEV inline
#define PD_SYNC() ((void)0)
#define PD_TID 0
#define PD_NTHREADS 1
#else
#include <cuda_runtime.h>
#define PD_DEV __device__ __forceinline__
#define PD_SYNC() __syncthreads()
#define PD_TID ((int)threadIdx.x)
#define PD_NTHREADS ((int)blockDim.x)
#endif

// block-strided loop: every thread of the block takes indices tid, tid + T, ...
#define PD_PAR(t, count) for (int t = PD_TID; t < (count); t += PD_NTHREADS)

namespace {

constexpr float kFrozenR = 999.0f;  // models/bp.py FROZEN_R
constexpr int kMaxThreads = 512;

// ops/chk.py lut_correction: the balanced select tree with the table's
// literal values (NaN falls to bin 0 exactly as there).
PD_DEV float lut(float x) {
  if (x >= 1.05f) {
    if (x >= 2.252f) return x >= 4.5f ? 0.0f : 0.05f;
    return x >= 1.508f ? 0.15f : 0.25f;
  }
  if (x >= 0.433f) return x >= 0.71f ? 0.35f : 0.45f;
  return x >= 0.196f ? 0.55f : 0.65f;
}

// Flavours: 0 minsum_lut (chk), 1 minsum_lut_fast (chk_fast), 2 spa
// (chk_exact).  Products are by +-1 or 0.5 and therefore exact, so FMA
// contraction cannot change a result.
template <int FL>
PD_DEV float chk(float a, float b) {
  if (FL == 1) {
    float ap = fabsf(a + b);
    float aq = fabsf(a - b);
    return 0.5f * (ap - aq) + (lut(ap) - lut(aq));
  }
  float s = ((a >= 0.0f) == (b >= 0.0f)) ? 1.0f : -1.0f;
  float m = fminf(fabsf(a), fabsf(b));
  if (FL == 0) {
    return s * m + (lut(fabsf(a + b)) - lut(fabsf(a - b)));
  }
  return s * m + log1pf(expf(-fabsf(a + b))) -
         log1pf(expf(-fabsf(a - b)));
}

// Per-block view of shared memory.  Frame f's planes start at
// msg + f * 2(n+1)N: planes 0..n are L, planes n+1..2n+1 are R (the
// stage-major order of models/bp.py wave_init_state).
struct Block {
  int n, N, F;
  float* msg;
  uint8_t* bits;  // F x N scratch for the G-matrix check
  int* done;      // F latch flags
  int* ok;        // F check results
  int* all;       // 1 block-uniform flag

  PD_DEV float* frame(int f) const { return msg + (size_t)f * 2 * (n + 1) * N; }
  PD_DEV float* L(int f, int i) const { return frame(f) + (size_t)i * N; }
  PD_DEV float* R(int f, int i) const { return frame(f) + (size_t)(n + 1 + i) * N; }
  // u = 0 on frozen positions (R[0] = 999 > 0), else sign(L[0] + R[0])
  PD_DEV int8_t decide(int f, int p) const {
    float r0 = R(f, 0)[p];
    return (r0 > 0.0f) ? 0 : (int8_t)((L(f, 0)[p] + r0) < 0.0f);
  }
};

inline size_t smem_bytes(int n, int F) {
  size_t N = (size_t)1 << n;
  return (size_t)F * 2 * (n + 1) * N * sizeof(float) + (size_t)F * N +
         (3 * (size_t)F + 1) * sizeof(int) + 16;
}

PD_DEV Block carve(float* smem, int n, int F) {
  Block b;
  b.n = n;
  b.N = 1 << n;
  b.F = F;
  b.msg = smem;
  size_t words = (size_t)F * 2 * (n + 1) * b.N;
  b.bits = reinterpret_cast<uint8_t*>(smem + words);
  // int flags after the byte scratch, 4-byte aligned (F N is a multiple of 4
  // for N >= 4; round up anyway)
  size_t off = ((size_t)F * b.N + 3) & ~(size_t)3;
  b.done = reinterpret_cast<int*>(b.bits + off);
  b.ok = b.done + F;
  b.all = b.ok + F;
  return b;
}

// Butterfly t of the block -> (frame f, upper index up) at stage i.
#define PD_BUTTERFLY(t, i, f, up)                              \
  int f = (t) >> (bk.n - 1);                                   \
  int k_ = (t) & ((bk.N >> 1) - 1);                            \
  int up = ((k_ >> (i)) << ((i) + 1)) | (k_ & ((1 << (i)) - 1))

// One flooding iteration (models/bp.py bp_iteration).
template <int FL>
PD_DEV void iterate(const Block& bk) {
  const int nb = bk.F * (bk.N >> 1);
  for (int i = 0; i < bk.n; ++i) {
    const int d = 1 << i;
    PD_PAR(t, nb) {
      PD_BUTTERFLY(t, i, f, up);
      const float* Ri = bk.R(f, i);
      const float* Li1 = bk.L(f, i + 1);
      float* Ri1 = bk.R(f, i + 1);
      float ru = Ri[up], rd = Ri[up + d], lu = Li1[up], ld = Li1[up + d];
      Ri1[up] = chk<FL>(ru, ld + rd);
      Ri1[up + d] = rd + chk<FL>(ru, lu);
    }
    PD_SYNC();
  }
  for (int i = bk.n - 1; i >= 0; --i) {
    const int d = 1 << i;
    PD_PAR(t, nb) {
      PD_BUTTERFLY(t, i, f, up);
      const float* Ri = bk.R(f, i);
      const float* Li1 = bk.L(f, i + 1);
      float* Li = bk.L(f, i);
      float ru = Ri[up], rd = Ri[up + d], lu = Li1[up], ld = Li1[up + d];
      Li[up] = chk<FL>(lu, ld + rd);
      Li[up + d] = ld + chk<FL>(ru, lu);
    }
    PD_SYNC();
  }
}

// G-matrix stopping rule per frame: ok[f] = (polar_encode(u) equals the
// posterior channel-stage decision sign(L[n] + R[n])).  Ends on a barrier.
PD_DEV void g_check(const Block& bk) {
  const int nf = bk.F * bk.N;
  PD_PAR(t, nf) {
    int f = t >> bk.n, p = t & (bk.N - 1);
    bk.bits[t] = (uint8_t)bk.decide(f, p);
  }
  PD_PAR(t, bk.F) bk.ok[t] = 1;
  PD_SYNC();
  // x = u F^{tensor n}: stage-i pairs at distance 2^i, upper ^= lower
  const int nb = bk.F * (bk.N >> 1);
  for (int i = 0; i < bk.n; ++i) {
    PD_PAR(t, nb) {
      PD_BUTTERFLY(t, i, f, up);
      uint8_t* x = bk.bits + (size_t)f * bk.N;
      x[up] ^= x[up + (1 << i)];
    }
    PD_SYNC();
  }
  PD_PAR(t, nf) {
    int f = t >> bk.n, p = t & (bk.N - 1);
    uint8_t post = (bk.L(f, bk.n)[p] + bk.R(f, bk.n)[p]) < 0.0f;
    if (bk.bits[t] != post) bk.ok[f] = 0;  // every writer stores 0
  }
  PD_SYNC();
}

// Latch frames whose check passed: store their decision now.  Ends on a
// barrier; bk.all is then the block-uniform "every frame latched".
PD_DEV void latch(const Block& bk, int f0, int8_t* out) {
  const int nf = bk.F * bk.N;
  PD_PAR(t, nf) {
    int f = t >> bk.n, p = t & (bk.N - 1);
    if (bk.ok[f] && !bk.done[f]) out[(size_t)(f0 + f) * bk.N + p] = bk.decide(f, p);
  }
  PD_SYNC();
  PD_PAR(t, bk.F) if (bk.ok[t]) bk.done[t] = 1;
  PD_SYNC();
  if (PD_TID == 0) {
    int a = 1;
    for (int f = 0; f < bk.F; ++f) a &= bk.done[f];
    *bk.all = a;
  }
  PD_SYNC();
}

// Decisions of frames that never latched.
PD_DEV void finish(const Block& bk, int f0, int8_t* out) {
  PD_PAR(t, bk.F * bk.N) {
    int f = t >> bk.n, p = t & (bk.N - 1);
    if (!bk.done[f]) out[(size_t)(f0 + f) * bk.N + p] = bk.decide(f, p);
  }
}

template <int FL>
PD_DEV void decode_block(int blk, float* smem, const float* llr,
                         const int8_t* frozen, int8_t* out, int n, int F,
                         int iters, int es_every) {
  Block bk = carve(smem, n, F);
  const int N = bk.N, S2 = 2 * (n + 1), f0 = blk * F;
  PD_PAR(t, F * N) {
    int f = t >> n, p = t & (N - 1);
    float* m = bk.frame(f);
    for (int q = 0; q < S2; ++q) m[(size_t)q * N + p] = 0.0f;
    m[(size_t)n * N + p] = llr[(size_t)(f0 + f) * N + p];
    m[(size_t)(n + 1) * N + p] = frozen[p] ? kFrozenR : 0.0f;
  }
  PD_PAR(t, F) bk.done[t] = 0;
  PD_SYNC();
  for (int it = 0; it < iters; ++it) {
    iterate<FL>(bk);
    if (es_every > 0 && (it + 1) % es_every == 0) {
      g_check(bk);
      latch(bk, f0, out);
      if (*bk.all) return;
    }
  }
  finish(bk, f0, out);
}

template <int FL>
PD_DEV void wave_block(int blk, float* smem, const float* state_in,
                       const float* llr, const int8_t* retire,
                       float* state_out, int8_t* u_out, int8_t* done_out,
                       int B, int n, int F, int iters, int check_every) {
  Block bk = carve(smem, n, F);
  const int N = bk.N, S2 = 2 * (n + 1), f0 = blk * F;
  // refill-merge (models/bp.py wave_merge): a retired slot restarts from
  // its fresh LLRs with every plane zero except L[n] and the frozen R[0]
  PD_PAR(t, F * N) {
    int f = t >> n, p = t & (N - 1), b = f0 + f;
    bool fresh = retire[b] != 0;
    float* m = bk.frame(f);
    for (int q = 0; q < S2; ++q) {
      float v = state_in[((size_t)q * B + b) * N + p];
      if (fresh && q != n + 1) v = (q == n) ? llr[(size_t)b * N + p] : 0.0f;
      m[(size_t)q * N + p] = v;
    }
  }
  PD_PAR(t, F) bk.done[t] = 0;
  PD_SYNC();
  // check_every = 0 checks once, at the wave boundary
  const int ce = check_every > 0 ? check_every : iters;
  for (int it = 0; it < iters; ++it) {
    iterate<FL>(bk);
    if ((it + 1) % ce == 0 || it + 1 == iters) {
      g_check(bk);
      latch(bk, f0, u_out);
    }
  }
  finish(bk, f0, u_out);
  PD_PAR(t, F * N) {
    int f = t >> n, p = t & (N - 1), b = f0 + f;
    const float* m = bk.frame(f);
    for (int q = 0; q < S2; ++q) state_out[((size_t)q * B + b) * N + p] = m[(size_t)q * N + p];
  }
  PD_PAR(t, F) done_out[f0 + t] = (int8_t)bk.done[t];
}

int log2_exact(int64_t N) {
  int n = 0;
  while (((int64_t)1 << n) < N) ++n;
  return ((int64_t)1 << n) == N ? n : -1;
}

int threads_for(int n, int F) {
  int nb = F * (1 << (n - 1));
  return nb < kMaxThreads ? nb : kMaxThreads;
}

#ifdef PD_HOST

template <int FL>
void run_decode(const float* llr, const int8_t* fr, int8_t* out, int nblk,
                int n, int F, int iters, int es) {
  std::vector<float> smem((smem_bytes(n, F) + 3) / 4);
  for (int blk = 0; blk < nblk; ++blk)
    decode_block<FL>(blk, smem.data(), llr, fr, out, n, F, iters, es);
}

template <int FL>
void run_wave(const float* st, const float* llr, const int8_t* ret, float* so,
              int8_t* u, int8_t* dn, int B, int nblk, int n, int F, int iters,
              int ce) {
  std::vector<float> smem((smem_bytes(n, F) + 3) / 4);
  for (int blk = 0; blk < nblk; ++blk)
    wave_block<FL>(blk, smem.data(), st, llr, ret, so, u, dn, B, n, F, iters, ce);
}

#else

template <int FL>
__global__ void decode_kernel(const float* llr, const int8_t* fr, int8_t* out,
                              int n, int F, int iters, int es) {
  extern __shared__ float smem[];
  decode_block<FL>(blockIdx.x, smem, llr, fr, out, n, F, iters, es);
}

template <int FL>
__global__ void wave_kernel(const float* st, const float* llr,
                            const int8_t* ret, float* so, int8_t* u,
                            int8_t* dn, int B, int n, int F, int iters,
                            int ce) {
  extern __shared__ float smem[];
  wave_block<FL>(blockIdx.x, smem, st, llr, ret, so, u, dn, B, n, F, iters, ce);
}

ffi::Error launched(const char* what) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " + cudaGetErrorString(e));
  return ffi::Error::Success();
}

template <typename K>
ffi::Error allow_smem(K kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("shared memory request: ") +
                                cudaGetErrorString(e));
  return ffi::Error::Success();
}

template <int FL>
ffi::Error launch_decode(cudaStream_t s, const float* llr, const int8_t* fr,
                         int8_t* out, int nblk, int n, int F, int iters,
                         int es) {
  size_t bytes = smem_bytes(n, F);
  ffi::Error err = allow_smem(decode_kernel<FL>, bytes);
  if (!err.success()) return err;
  decode_kernel<FL><<<nblk, threads_for(n, F), bytes, s>>>(llr, fr, out, n, F,
                                                           iters, es);
  return launched("pd_bp_decode");
}

template <int FL>
ffi::Error launch_wave(cudaStream_t s, const float* st, const float* llr,
                       const int8_t* ret, float* so, int8_t* u, int8_t* dn,
                       int B, int nblk, int n, int F, int iters, int ce) {
  size_t bytes = smem_bytes(n, F);
  ffi::Error err = allow_smem(wave_kernel<FL>, bytes);
  if (!err.success()) return err;
  wave_kernel<FL><<<nblk, threads_for(n, F), bytes, s>>>(st, llr, ret, so, u,
                                                         dn, B, n, F, iters, ce);
  return launched("pd_bp_wave");
}

#endif

// Shape checks shared by both builds.  Returns n, or -1 with *msg set.
int check_frames(int64_t B, int64_t N, int32_t F, int32_t flavor,
                 std::string* msg) {
  int n = log2_exact(N);
  if (n < 1) {
    *msg = "N must be a power of two >= 2";
    return -1;
  }
  if (F < 1 || B % F != 0) {
    *msg = "batch must be a positive multiple of frames_per_block";
    return -1;
  }
  if (flavor < 0 || flavor > 2) {
    *msg = "unknown flavor";
    return -1;
  }
  return n;
}

#ifdef PD_HOST
#define PD_STREAM_ARG
#define PD_STREAM_BIND
#define PD_CALL(FL, kind, ...) run_##kind<FL>(__VA_ARGS__)
#else
#define PD_STREAM_ARG cudaStream_t stream,
#define PD_STREAM_BIND .Ctx<ffi::PlatformStream<cudaStream_t>>()
#define PD_CALL(FL, kind, ...) err = launch_##kind<FL>(stream, __VA_ARGS__)
#endif

ffi::Error BpDecodeImpl(PD_STREAM_ARG ffi::Buffer<ffi::F32> llr,
                        ffi::Buffer<ffi::S8> frozen,
                        ffi::ResultBuffer<ffi::S8> out, int32_t iters,
                        int32_t flavor, int32_t early_stop_every,
                        int32_t frames_per_block) {
  auto dims = llr.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("llr must be [B, N]");
  std::string msg;
  int n = check_frames(dims[0], dims[1], frames_per_block, flavor, &msg);
  if (n < 0) return ffi::Error::InvalidArgument(msg);
  int nblk = (int)(dims[0] / frames_per_block);
  ffi::Error err = ffi::Error::Success();
  const float* x = llr.typed_data();
  const int8_t* fr = frozen.typed_data();
  int8_t* u = out->typed_data();
  switch (flavor) {
    case 0: PD_CALL(0, decode, x, fr, u, nblk, n, frames_per_block, iters, early_stop_every); break;
    case 1: PD_CALL(1, decode, x, fr, u, nblk, n, frames_per_block, iters, early_stop_every); break;
    default: PD_CALL(2, decode, x, fr, u, nblk, n, frames_per_block, iters, early_stop_every); break;
  }
  return err;
}

ffi::Error BpWaveImpl(PD_STREAM_ARG ffi::Buffer<ffi::F32> state,
                      ffi::Buffer<ffi::F32> llr, ffi::Buffer<ffi::S8> retire,
                      ffi::ResultBuffer<ffi::F32> state_out,
                      ffi::ResultBuffer<ffi::S8> u_out,
                      ffi::ResultBuffer<ffi::S8> done_out, int32_t iters,
                      int32_t flavor, int32_t check_every,
                      int32_t frames_per_block) {
  auto dims = state.dimensions();
  if (dims.size() != 3) return ffi::Error::InvalidArgument("state must be [2(n+1), B, N]");
  std::string msg;
  int n = check_frames(dims[1], dims[2], frames_per_block, flavor, &msg);
  if (n < 0) return ffi::Error::InvalidArgument(msg);
  if (dims[0] != 2 * (n + 1)) return ffi::Error::InvalidArgument("state must hold 2(n+1) planes");
  int B = (int)dims[1];
  int nblk = B / frames_per_block;
  ffi::Error err = ffi::Error::Success();
  const float* st = state.typed_data();
  const float* x = llr.typed_data();
  const int8_t* ret = retire.typed_data();
  float* so = state_out->typed_data();
  int8_t* u = u_out->typed_data();
  int8_t* dn = done_out->typed_data();
  switch (flavor) {
    case 0: PD_CALL(0, wave, st, x, ret, so, u, dn, B, nblk, n, frames_per_block, iters, check_every); break;
    case 1: PD_CALL(1, wave, st, x, ret, so, u, dn, B, nblk, n, frames_per_block, iters, check_every); break;
    default: PD_CALL(2, wave, st, x, ret, so, u, dn, B, nblk, n, frames_per_block, iters, check_every); break;
  }
  return err;
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PdBpDecode, BpDecodeImpl,
                              ffi::Ffi::Bind() PD_STREAM_BIND
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Attr<int32_t>("iters")
                                  .Attr<int32_t>("flavor")
                                  .Attr<int32_t>("early_stop_every")
                                  .Attr<int32_t>("frames_per_block"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(PdBpWave, BpWaveImpl,
                              ffi::Ffi::Bind() PD_STREAM_BIND
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Attr<int32_t>("iters")
                                  .Attr<int32_t>("flavor")
                                  .Attr<int32_t>("check_every")
                                  .Attr<int32_t>("frames_per_block"));
