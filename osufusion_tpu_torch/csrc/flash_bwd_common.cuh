// What the backward kernels share (flash_bwd.cu, flash_bwd_windowed.cu): the
// tile geometry, the mma.sync / ldmatrix / cp.async wrappers, the staging of
// q as the forward holds it, and the small kernel for delta = rowsum(do * o).
//
// Everything sits in an unnamed namespace, so each library gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head dim
constexpr int BN = 64;      // keys per KV tile
constexpr int LDS = D + 8;  // padded shared-memory row, in bf16 (BN == D, so one pitch serves every tile)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(BN == 64 && D == 64, "fragment loops assume 64-key, 64-wide tiles");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment (rows row0..row0+15, columns kk*16..kk*16+15) of a row-major
// tile in one ldmatrix: the four 8x8 matrices are (rows 0-7 | 8-15) x
// (columns 0-7 | 8-15), in the order of the fragment's registers
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0, int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
}

// B fragments of two adjacent 8-key tiles (keys key0..key0+15) at depth
// kk*16..kk*16+15, from a [key][d] row-major tile: registers 0,1 serve the
// first key tile, 2,3 the second
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int key0, int kk, int lane) {
  ldmatrix_x4(b, tile + (key0 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
}

// Copy the KV tile of keys s0..s0+BN-1 of one batch element into shared
// memory with cp.async (no commit); keys at or past S arrive as zeros. ld is
// the elements from one key to the next (D, or Kv * D for one of Kv heads)
template <int NTHREADS>
__device__ __forceinline__ void copy_kv_tile(__nv_bfloat16* Ks, __nv_bfloat16* Vs, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, int s0, int S, int tid, int ld = D) {
  for (int c = tid; c < BN * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    const size_t off = (size_t)(ok ? s : 0) * ld + col;
    cp_async16(Ks + r * LDS + col, kb + off, ok);
    cp_async16(Vs + r * LDS + col, vb + off, ok);
  }
}

// The (timestep, head) row of a (B, T, H, D) tensor that row r of a block's
// rows is. MQA: the rows are the T*H contiguous rows (r itself). GROUPED: the
// rows of one KV group, whose G heads sit among the H of every timestep
// (the pointer already at the group's first head): timestep r / G, head r % G.
template <bool GROUPED>
__device__ __forceinline__ int group_row(int r, int G, int H) {
  return GROUPED ? (r / G) * H + r % G : r;
}

// Copy ROWS rows of a (rows, D) bf16 matrix starting at row r0 into a padded
// tile with cp.async (no commit); rows at or past row_end arrive as zeros.
// GROUPED: the rows of one KV group of G heads among H (group_row)
template <int ROWS, int NTHREADS, bool GROUPED = false>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* tile, const __nv_bfloat16* src, int r0, int row_end, int tid,
                                          int G = 0, int H = 0) {
  for (int c = tid; c < ROWS * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const bool ok = r0 + r < row_end;
    cp_async16(tile + r * LDS + col, src + (size_t)group_row<GROUPED>(ok ? r0 + r : 0, G, H) * D + col, ok);
  }
}

// Stage ROWS (timestep, head) rows of raw q, from row r0 on, as the forward
// holds them: qs = rope(q) * qscale, rotated in fp32 and rounded to bf16, so
// that qs k_rot^T repeats the forward's logits bit for bit (without ROPE, qs =
// q * qscale). Row r belongs to timestep r / H (GROUPED: r / G, the rows of
// one KV group, group_row). Rows at or past row_end are zeros.
//   out[d]      = q[d] cos[d] - q[d+32] sin[d]
//   out[d + 32] = q[d+32] cos[d+32] + q[d] sin[d+32]
template <int ROWS, int NTHREADS, bool GROUPED = false, bool ROPE = true>
__device__ __forceinline__ void stage_qs(__nv_bfloat16* Qs, const __nv_bfloat16* qb, const float* cos_t,
                                         const float* sin_t, int r0, int row_end, int H, float qscale, int tid,
                                         int G = 0) {
  for (int c = tid; c < ROWS * (D / 16); c += NTHREADS) {
    const int r = c / (D / 16);
    const int col = (c % (D / 16)) * 8;  // 8 columns of the low half, and their partners
    const int row = r0 + r;
    float lo[8], hi[8];
    if (row < row_end) {
      const __nv_bfloat16* qr = qb + (size_t)group_row<GROUPED>(row, G, H) * D;
      const uint4 ql = *reinterpret_cast<const uint4*>(qr + col);
      const uint4 qh = *reinterpret_cast<const uint4*>(qr + col + D / 2);
      const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&ql);
      const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&qh);
      if (ROPE) {
        // the tables' rows are 256 bytes and col is a multiple of 8: 16-byte loads
        const int t = row / (GROUPED ? G : H);
        const float4* cr = reinterpret_cast<const float4*>(cos_t + (size_t)t * D + col);
        const float4* sr = reinterpret_cast<const float4*>(sin_t + (size_t)t * D + col);
        const float4 c4[4] = {cr[0], cr[1], cr[D / 8], cr[D / 8 + 1]};  // low half, then its partners
        const float4 s4[4] = {sr[0], sr[1], sr[D / 8], sr[D / 8 + 1]};
        const float* cl = reinterpret_cast<const float*>(c4);
        const float* sl = reinterpret_cast<const float*>(s4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = __bfloat162float(xl[j]);
          const float h = __bfloat162float(xh[j]);
          lo[j] = (a * cl[j] - h * sl[j]) * qscale;
          hi[j] = (h * cl[8 + j] + a * sl[8 + j]) * qscale;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lo[j] = __bfloat162float(xl[j]) * qscale;
          hi[j] = __bfloat162float(xh[j]) * qscale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.f;
    }
    uint4 pl, ph;
    pl.x = pack_bf16(lo[0], lo[1]); pl.y = pack_bf16(lo[2], lo[3]);
    pl.z = pack_bf16(lo[4], lo[5]); pl.w = pack_bf16(lo[6], lo[7]);
    ph.x = pack_bf16(hi[0], hi[1]); ph.y = pack_bf16(hi[2], hi[3]);
    ph.z = pack_bf16(hi[4], hi[5]); ph.w = pack_bf16(hi[6], hi[7]);
    *reinterpret_cast<uint4*>(Qs + r * LDS + col) = pl;
    *reinterpret_cast<uint4*>(Qs + r * LDS + col + D / 2) = ph;
  }
}

// delta[r] = sum_d do[r][d] * o[r][d] in fp32: eight threads a row, 16 bytes each
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ o,
                                       float* __restrict__ delta, size_t n_rows) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx / (D / 8);
  float acc = 0.f;
  if (row < n_rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + idx * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(o + idx * 8);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(pa[j]);
      const float2 y = __bfloat1622float2(pb[j]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
  // the eight threads of a row are neighbours in one warp (blockDim.x is a multiple of 32)
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < n_rows && (idx & 7) == 0) delta[row] = acc;
}

// Launch the delta kernel over n_rows rows of do and o on stream st
inline cudaError_t launch_delta(const void* dout, const void* o, void* delta, size_t n_rows, cudaStream_t st) {
  const size_t threads = n_rows * (D / 8);
  flash_bwd_delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o), static_cast<float*>(delta), n_rows);
  return cudaGetLastError();
}

}  // namespace
