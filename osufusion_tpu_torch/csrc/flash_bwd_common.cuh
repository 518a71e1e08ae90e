// What the halo forward (flash_halo.cu, K4) is built from: the tile
// geometry and the mma.sync / ldmatrix / cp.async wrappers. The halo backward
// runs on the Hopper pair of flash_bwd_windowed.cu, and every other flash
// kernel is built from hopper.cuh too, so this header goes with K4's redesign.
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
// memory with cp.async (no commit); keys at or past S arrive as zeros
template <int NTHREADS>
__device__ __forceinline__ void copy_kv_tile(__nv_bfloat16* Ks, __nv_bfloat16* Vs, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, int s0, int S, int tid) {
  for (int c = tid; c < BN * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    const size_t off = (size_t)(ok ? s : 0) * D + col;
    cp_async16(Ks + r * LDS + col, kb + off, ok);
    cp_async16(Vs + r * LDS + col, vb + off, ok);
  }
}

}  // namespace
