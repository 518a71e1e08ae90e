// Flash attention above head dim 256 on the tensor cores, for Hopper
// (sm_90a): the forward at every head dim above 256 that is a multiple of 64
// (the forms family's chunked forward, forms_fwd_chunked_kernel, which served
// D > 512 on the FMA units, is deleted) and the backward pair (dq, dk/dv) at
// D = 320, 384, 448 and 512, templated on the operand type E (bf16 or fp16).
// The entry points are flash_xwide.cu's (bf16) and flash_xwide_f16.cu's
// (fp16), one library each, so that the two types compile side by side.
//
// Replaces, at those head dims, osufusion_tpu/ops/pallas_attention.py::
//  * _fwd_kernel (:208, launched by _flash_fwd), _halo_fwd_kernel (:938,
//    launched by _halo_flash_fwd) and one hop of _ring_fwd (:1310):
//    xwide_fwd_kernel, windowed or global, MQA / GQA / full MHA (query head h
//    reads KV head h / (H / Kv)), fused q-RoPE or none, o in E and the base-2
//    LSE in fp32, in the single-device or the halo frame (key_frame.cuh);
//  * _dq_kernel (:435), _halo_dq_kernel (:1054) and the dq part of
//    _bwd_fused_kernel (:575, also each hop of _ring_bwd :1338):
//    xwide_dq_kernel;
//  * _dkv_kernel (:507), _halo_dkv_kernel (:1099) and the dk/dv part of
//    _bwd_fused_kernel: xwide_dkv_kernel, which sums the G query heads of a
//    KV head.
// The pair reads the forms family's pre-pass scratch (flash_forms.cu's
// forms_prep_kernel: qs in E, do in group-major order, the LSE and delta
// padded to 64-row tiles) and leaves dq in its fp32 buffer for the forms
// post-pass, as the chunked instance it replaces did; dq_acc, dk and dv are
// stored, or with `accumulate` added to (the ring's hops). Every backward
// wrapper at these head dims runs it: the global backward, the ring's sweep,
// the windowed pair and the halo pair.
//
// The arithmetic is the Pallas bodies': logits in the exp2 domain, qs =
// rope(q) * D^-0.5 * log2(e) rounded to E (rope_qs.cuh, the pre-pass's bits),
// fp32 accumulators, P rounded to E before P V (:284), P before dV and dS
// before dQ and dK likewise (:492, :564, :641-644):
//   forward: o = softmax2(qs k^T) v,  lse2 = log2 sum exp2(qs k^T)
//   dq_acc  (+)= ds k                 ds = p (do v^T - delta), p = exp2(qs k^T - lse2)
//   dk      (+)= ln(2) ds^T qs,  dv (+)= p^T do
//
// Bound: compute (4 D FLOP per visited (query, key) pair forward, 6 D in dq,
// 8 D in dk/dv, on the tensor cores; a row meets up to W + 1 or S keys for a
// few kilobytes of traffic).
//
// The design problem is the width. Below 257 a 64-row warpgroup keeps its
// output (O, dQ, or dK and dV of 64 keys) in D / 2 fp32 registers a thread
// (flash_fwd.cuh, flash_bwd_windowed.cuh). Here that would be 160 to 256, and
// a 64-wide tile of all four operands (qs, do, k, v: 64 x D x 2 bytes each,
// 64 KB at D = 512) no longer fits shared memory twice. So:
//  * The output's head dim is split across the block's two consumer
//    warpgroups, in 64-column swizzle atoms (hopper.cuh): the D-wide products
//    (S, and dP in the backward) are computed once, by one warpgroup each,
//    and P (and dS) cross to the other through shared memory, each thread
//    writing the accumulator registers that the same thread of the other
//    warpgroup reads back (the two hold the same entries of the product). Only dk/dv, whose two outputs of 64 keys at D = 512 would fill
//    the whole register file, is also split across blocks: a grid axis over
//    column chunks of at most XW_DKV_ATOMS atoms, each block recomputing S^T
//    and dP^T (one chunk at D = 320, two above).
//  * The operand that each block sweeps, and every output atom's operand,
//    streams through shared memory as atoms of 64 columns: 64 rows or keys
//    (8 KB) in the pair, 128 keys (16 KB) in the forward. One ring per
//    consumer warpgroup, each fed by its own producer thread in the order the
//    warpgroup consumes them, so neither warpgroup waits on the other's loads;
//    each ring takes as many slots as the block's shared memory holds beside
//    its resident rows (xw_slots, at most XW_MAX_SLOTS). An atom is used by
//    one product group and released when the group after it is issued and the
//    group itself is done (two groups in flight; a third starved the rings of
//    dq and dk/dv at D = 512). The operand that is used twice per tile (k in
//    dq: S, then dQ += dS K; qs and do in dk/dv) is streamed twice; the
//    block's resident rows (q in the forward, qs and do in dq, k and v in
//    dk/dv) stay in shared memory, D / 64 atoms each.
//  * Per tile of 128 keys (forward), 64 keys (dq) or 64 rows (dk/dv):
//      forward: warpgroup 0 S = qs K^T (wgmma m64n128: 128 keys halve the
//               dependent products and hand-overs a key against 64, and the
//               shared-memory reads of qs a FLOP), the online softmax, P to
//               1; both O[:, own atoms] += P V (warpgroup 0 at most
//               XW_FWD_ATOMS0 of the atoms, 1 the rest, at most
//               XW_FWD_ATOMS1: warpgroup 0's softmax is the critical path);
//      dq:      warpgroup 0 S = qs K^T and P, to 1; 1 dP = do V^T and dS =
//               P (dP - delta), to 0; both dQ[:, own half] += dS K;
//      dk/dv:   warpgroup 0 S^T = K qs^T and P^T, to 1, and dV += P^T do;
//               1 dP^T = V do^T, dS^T = P^T (dP^T - delta), dK += dS^T qs.
//    One named barrier a hand-over; P (P^T) crosses in fp32 where the other
//    side needs it unrounded (ds), in E where it is the A operand of P V.
//    Every exp2 is the special-function unit's instruction alone (hopper.cuh's
//    exp2_ftz), as in K1.
//  * Registers (fp32 accumulators, a thread of a 64-row warpgroup; the
//    producer warpgroup hands its registers over by setmaxnreg, 240 a
//    consumer thread; ptxas reports the 168 of the launch):
//      forward: warpgroup 0 S 64 + P 32 + O at most 3 x 32; 1 O at most 5 x 32 + P 32
//      dq:      each S or dP 32 + dS 16 + dQ at most 4 x 32
//      dk/dv:   each S^T or dP^T 32 + P^T or dS^T 16 + dV or dK at most 5 x 32
//  * Shared memory (KB, of the 227 a block may take; the resident rows, the
//    hand-over buffers and the barriers, then the two rings' slots):
//      D                          320       384       448       512
//      forward: q + hand-over     40 + 36   48 + 36   56 + 36   64 + 36   rings 2 x 4 x 16 (3 at 512)
//      dq:      qs + do + 24      80 + 25   96 + 25   112 + 25  128 + 25  rings 2 x 7 / 6 / 5 / 4 x 8
//      dk/dv:   k + v + 32        80 + 33   96 + 33   112 + 33  128 + 33  rings 2 x 7 / 6 / 5 / 4 x 8
//    at most 226 KB (dk/dv: 231424 bytes).
//  * Masks as in flash_fwd.cuh and flash_bwd_windowed.cuh: only a tile at
//    the window's edge or past the keys that exist ([kf.lo, kf.hi)) is
//    masked, each entry with one unsigned compare.
// The forward above XW_MAX_D (xwide_fwd_kernel<E, STREAM = true>): O's atoms
// no longer fit the two warpgroups (XW_FWD_ATOMS0 + XW_FWD_ATOMS1 = 8), nor q
// shared memory beside rings of three slots above D = 704. So
//  * O's columns go in chunks of at most 8 atoms on the grid's z axis
//    (xw_chunk: 5 + 4 at 576, 8 + 8 at 1024), each chunk's block computing S
//    again over the whole head dim (1.5x the tensor-core work of S and P V
//    at 576 against one chunk); only chunk 0's block writes the LSE;
//  * xw_qs_kernel writes qs (rope_qs.cuh's bits, group-major rows) to device
//    memory first, and each atom of it streams through ring 0 in the slot of
//    the K atom it multiplies (slots of 16 + 8 KB there, 4 a ring), at every
//    head dim above XW_MAX_D, so that one instance takes all of them.
//    ptxas: 168 registers at launch, no spill; C7520 (wgmma serialised by a
//    compiler-inserted WG.AR in a divergent path) on both forward instances,
//    as on the pair.
//
// C ABI (loaded with ctypes), each entry point taking the head dim first and
// returning a cudaError_t (cudaErrorInvalidValue for a head dim that is not a
// multiple of 64, the pair's also outside XW_MIN_D ... XW_MAX_D, or the
// forward above XW_MAX_D without its scratch), or minus the CUresult of a
// TMA descriptor that failed to encode: xwide_fwd_<type> and
// xwide_halo_fwd_<type> take flash_fwd_<type>'s and halo_fwd_<type>'s
// arguments (flash_fwd.cuh) and the scratch of qs above XW_MAX_D (the
// forward takes every multiple of 64), xwide_bwd_dq_<type> and xwide_bwd_dkv_<type>
// those of flash_forms.cu's forms_bwd_dq and forms_bwd_dkv without the type
// code.
//
// Everything sits in an unnamed namespace, so each library gets its own copy.

#pragma once

#include <limits.h>
#include <math.h>

#include "hopper.cuh"
#include "key_frame.cuh"
#include "rope_qs.cuh"

namespace {

constexpr int XW_ROWS = 64;                 // rows (keys) of a block, of a tile and of an atom
constexpr int XW_ATOM = XW_ROWS * 64;       // elements of a 64 x 64 swizzle atom
constexpr int XW_ATOM_BYTES = XW_ATOM * 2;  // 8 KB
constexpr int XW_MAX_SLOTS = 16;            // atoms in flight on each ring at most (as many as shared memory holds)
constexpr int XW_THREADS = 3 * 128;         // two consumer warpgroups and the producer warpgroup
constexpr int XW_PRODUCER_REGS = 24;        // registers a thread after the hand-over
constexpr int XW_CONSUMER_REGS = 240;
constexpr int XW_SMEM_LIMIT = 232448;       // dynamic shared memory a block may take on sm_90
constexpr int XW_MIN_D = 320, XW_MAX_D = 512;
constexpr int XW_FWD_KEYS = 128;                     // keys of a forward tile (its K and V atoms: 128 x 64)
constexpr int XW_FWD_SLOT = XW_FWD_KEYS * 64 * 2;     // 16 KB
constexpr int XW_FWD_ATOMS0 = 3, XW_FWD_ATOMS1 = 5;  // o atoms of warpgroup 0 / 1 at most
constexpr int XW_DQ_ATOMS = 4;                       // dq atoms of either warpgroup at most
constexpr int XW_DKV_ATOMS = 5;                      // dk (and dv) atoms of a block at most
constexpr float XW_LOG2E = 1.4426950408889634f;
constexpr float XW_LN2 = 0.6931471805599453f;
static_assert(2 * 128 * XW_CONSUMER_REGS + 128 * XW_PRODUCER_REGS <= 65536, "the hand-over fits the register file");
static_assert(XW_MAX_D / 64 <= XW_FWD_ATOMS0 + XW_FWD_ATOMS1 && XW_MAX_D / 64 <= 2 * XW_DQ_ATOMS,
              "the forward and dq keep every column of a row in one block up to XW_MAX_D (no column chunks)");

// ---- the rings: atoms behind full / empty mbarriers ----

// The shared memory of each kernel at A = D / 64 atoms before its two rings,
// from the 1024-byte-aligned base: the resident rows, the hand-over buffers
// and the barriers (2 x 2 x XW_MAX_SLOTS of the rings, and one for the
// resident rows), rounded up to 1024 bytes so the rings' atoms stay aligned
__host__ __device__ constexpr int xw_align(int bytes) { return (bytes + 1023) / 1024 * 1024; }
constexpr int XW_BARS = (4 * XW_MAX_SLOTS + 1) * 8;
__host__ __device__ constexpr int xw_fwd_fixed(int A) {
  return xw_align(A * XW_ATOM_BYTES + 2 * (XW_FWD_KEYS / 4) * 128 * 4 + 2 * 2 * 128 * 4 + 2 * 128 * 4 + XW_BARS);
}
__host__ __device__ constexpr int xw_dq_fixed(int A) {
  return xw_align(2 * A * XW_ATOM_BYTES + 32 * 128 * 4 + 16 * 128 * 4 + XW_BARS);
}
__host__ __device__ constexpr int xw_dkv_fixed(int A) { return xw_align(2 * A * XW_ATOM_BYTES + 2 * 32 * 128 * 4 + XW_BARS); }
// the slots of each of the two rings, of `bytes0` and `bytes1` a slot, that the rest of the block's shared memory
// holds (the 1024 bytes of alignment aside), at most XW_MAX_SLOTS
__host__ __device__ constexpr int xw_slots2(int fixed, int bytes0, int bytes1) {
  return (XW_SMEM_LIMIT - 1024 - fixed) / (bytes0 + bytes1) < XW_MAX_SLOTS
             ? (XW_SMEM_LIMIT - 1024 - fixed) / (bytes0 + bytes1)
             : XW_MAX_SLOTS;
}
// ... of `bytes` a slot on both rings
__host__ __device__ constexpr int xw_slots(int fixed, int bytes = XW_ATOM_BYTES) { return xw_slots2(fixed, bytes, bytes); }
static_assert(xw_slots(xw_fwd_fixed(XW_MAX_D / 64), XW_FWD_SLOT) >= 3 &&
                  xw_slots2(xw_fwd_fixed(0), XW_FWD_SLOT + XW_ATOM_BYTES, XW_FWD_SLOT) >= 3 &&
                  xw_slots(xw_dq_fixed(XW_MAX_D / 64)) >= 4 &&
                  xw_slots(xw_dkv_fixed(XW_MAX_D / 64)) >= 4,
              "every kernel keeps three atoms or more in flight on each ring at XW_MAX_D");

struct XwRing {
  unsigned char* slots;  // [n][XW_ATOM] of 16-bit elements, 1024-aligned
  uint64_t* full;        // [n], one arrival (the producer's expect_tx) and the copy's bytes
  uint64_t* empty;       // [n], one arrival per warp of the consuming warpgroup
  int n;                 // slots, as many as the launch's shared memory holds (xw_slots)
  int bytes;             // of a slot: one atom of 64 rows or keys (the forward's: of 128 keys)
};

// a ring of n slots of `bytes` from `slots`, its barriers from `bars` (2 * XW_MAX_SLOTS of them)
__device__ __forceinline__ XwRing xw_ring(unsigned char* slots, uint64_t* bars, int n, int bytes = XW_ATOM_BYTES) {
  return {slots, bars, bars + XW_MAX_SLOTS, n, bytes};
}

__device__ __forceinline__ void xw_init_ring(const XwRing& r) {
  for (int s = 0; s < r.n; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], 4);
  }
}

// A position on a ring: the slot, and the parity of the round through it
struct XwPos {
  int st = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int n) {
    if (++st == n) {
      st = 0;
      phase ^= 1;
    }
  }
};

// The producer's side: one thread issues every copy of a ring, in order
struct XwFeed {
  XwRing r;
  XwPos at;
  // load(dst, bar) issues the copy of one atom into dst, completing on bar; `bytes` of the slot filled (the whole
  // slot unless given)
  template <typename Load>
  __device__ __forceinline__ void push(Load load, int bytes = 0) {
    mbar_wait(&r.empty[at.st], at.phase ^ 1);
    mbar_expect_tx(&r.full[at.st], bytes > 0 ? bytes : r.bytes);
    load(r.slots + at.st * r.bytes, &r.full[at.st]);
    at.advance(r.n);
  }
};

// The consumer's side: a warpgroup takes every atom of its ring in order,
// one product group each, and keeps at most two groups in flight (a third
// starved the four-slot rings of dq and dk/dv at D = 512)
struct XwTake {
  XwRing r;
  int lane;
  XwPos at;
  int held = -1;  // the slot of the last group issued, not yet released; -1: none
  // the next atom, once it has arrived
  __device__ __forceinline__ const void* take() {
    mbar_wait(&r.full[at.st], at.phase);
    return r.slots + at.st * r.bytes;
  }
  // after the group that reads the atom of take() is committed: the group
  // before it is done, so its atom goes back to the producer
  __device__ __forceinline__ void issued() {
    if (held >= 0) {
      wgmma_wait<1>();
      release(held);
    }
    held = at.st;
    at.advance(r.n);
  }
  // every group of the warpgroup is done and every atom released
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (held >= 0) release(held);
    held = -1;
  }
  __device__ __forceinline__ void release(int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[st]);
  }
};

template <int N>
__device__ __forceinline__ void xw_fence(float (&acc)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(acc[i]);
}

template <int N>
__device__ __forceinline__ void xw_zero(float (&acc)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
}

// S (64 x K, fp32; K = 64 or 128 keys or rows) = sum over the a atoms of
// A_a B_a^T, both K-major: A resident (atom i at a_base + i * XW_ATOM), B
// the next `atoms` atoms of the ring (K rows of 64 columns each); the
// logits-shaped product of every kernel here. STREAM: A_a streamed too, in
// B_a's slot after its K rows (the forward above XW_MAX_D)
template <typename E, int K, bool STREAM = false>
__device__ __forceinline__ void xw_dots(float (&s)[K / 2], const E* a_base, int atoms, XwTake& rd) {
  for (int a = 0; a < atoms; ++a) {
    const unsigned char* slot = static_cast<const unsigned char*>(rd.take());
    const uint64_t bd = desc_kmajor(slot);
    const uint64_t ad = STREAM ? desc_kmajor(slot + K * 128) : desc_kmajor(a_base + a * XW_ATOM);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<K, 0, 0, E>(s, ad + 2 * kk, bd + 2 * kk, a > 0 || kk > 0);
    wgmma_commit();
    rd.issued();
  }
}

// acc[i] (64 x 64 columns of atom i, fp32) += X B_i for the first n of the N
// atoms, X (64 x K) in E fragments (x), B_i the next atom of the ring (K
// rows of 64 columns) read MN-major (its K rows are the reduction)
template <typename E, int N, int K>
__device__ __forceinline__ void xw_outer(float (&acc)[N][32], const uint32_t (&x)[K / 16][4], int n, XwTake& rd) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const uint64_t bd = desc_mnmajor(rd.take());
#pragma unroll
      for (int j = 0; j < K / 16; ++j) wgmma_rs_n64<1, E>(acc[i], x[j], bd + j * (16 * 128 >> 4), 1);
      wgmma_commit();
      rd.issued();
    }
  }
}

// the F fragment registers of a 64-row tile in E, handed from one
// warpgroup's thread to the same thread of the other ([4 F][128] words)
template <int F>
__device__ __forceinline__ void xw_put_frags(uint32_t* buf, const uint32_t (&x)[F][4], int tid) {
#pragma unroll
  for (int j = 0; j < F; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) buf[(4 * j + e) * 128 + tid] = x[j][e];
}

template <int F>
__device__ __forceinline__ void xw_get_frags(const uint32_t* buf, uint32_t (&x)[F][4], int tid) {
#pragma unroll
  for (int j = 0; j < F; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = buf[(4 * j + e) * 128 + tid];
}

template <typename E, int F>
__device__ __forceinline__ void xw_frags(uint32_t (&x)[F][4], const float (&s)[8 * F]) {
#pragma unroll
  for (int j = 0; j < F; ++j) a_frag<E>(x[j], s + 8 * j);
}

// The dk/dv block's columns: atoms [c0, c1) of the head dim's A, the grid's
// z axis splitting them in chunks of at most XW_DKV_ATOMS
struct XwChunk {
  int c0, c1;
};

__device__ __forceinline__ XwChunk xw_chunk(int A) {
  const int per = (A + gridDim.z - 1) / gridDim.z;
  const int c0 = blockIdx.z * per;
  return {c0, min(A, c0 + per)};
}

// ---- the forward ----

// grid (ceil(T*G / 64), B * Kv, column chunks); frame {0, 0, S} on one
// device, halo_frame in the halo slab (q rotated, no tables). STREAM (D >
// XW_MAX_D): qs comes from xw_qs_kernel (qmap: its group-major rows, boxes of
// one atom of 64 rows), each of its atoms streamed through ring 0 in the slot
// of the K atom it multiplies, and the block's O columns are the grid's z
// chunk; else (D <= XW_MAX_D) the block stages qs from the raw q and holds it,
// and one chunk holds every column. qmap is unread without STREAM.
template <typename E, bool STREAM>
__global__ void __launch_bounds__(XW_THREADS, 1)
xwide_fwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qmap, const E* __restrict__ q, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, E* __restrict__ o, float* __restrict__ lse, int T, int H, int Kv,
                 int D, int window, float scale, KeyFrame kf, int slots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int A = D / 64;
  constexpr int BN = XW_FWD_KEYS, F = BN / 16;  // keys of a tile; P's fragment registers
  constexpr int SLOT0 = STREAM ? XW_FWD_SLOT + XW_ATOM_BYTES : XW_FWD_SLOT;  // ring 0's slot: a K atom (and a qs one)
  E* Qs = reinterpret_cast<E*>(smem);  // [A][64][64] qs, swizzled (none with STREAM)
  const int resident = STREAM ? 0 : A;
  uint32_t* xp = reinterpret_cast<uint32_t*>(smem + resident * XW_ATOM_BYTES);  // [2][4 F][128] P in E
  float* xc = reinterpret_cast<float*>(xp + 2 * 4 * F * 128);                  // [2][2][128] O's rescale
  float* xl = xc + 2 * 2 * 128;                                                // [2][128] 1 / l
  uint64_t* bars = reinterpret_cast<uint64_t*>(xl + 2 * 128);  // [2 rings][full, empty][XW_MAX_SLOTS]
  unsigned char* rings = smem + xw_fwd_fixed(resident);        // [slots][SLOT0], then [slots][BN][64]
  const XwRing ring0 = xw_ring(rings, bars, slots, SLOT0);
  const XwRing ring1 = xw_ring(rings + slots * SLOT0, bars + 2 * XW_MAX_SLOTS, slots, XW_FWD_SLOT);

  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int G = H / Kv, rows = T * G;  // the group's rows: group row r is timestep r / G, head kv * G + r % G
  const int r0 = blockIdx.x * XW_ROWS;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / G, t_hi = (min(r0 + XW_ROWS, rows) - 1) / G;
  const KeySpan span = keys_seen(kf, local, w2, t_lo, t_hi);  // the keys the block's rows see
  const int kv_lo = span.lo;
  const int n_tiles = (span.hi - kv_lo + BN - 1) / BN;
  const XwChunk ch = xw_chunk(A);  // the block's o atoms [c0, c1): every atom below XW_MAX_D
  const int n0 = max(0, ch.c1 - ch.c0 - XW_FWD_ATOMS1), n1 = ch.c1 - ch.c0 - n0;  // warpgroup 0's (the first), 1's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    xw_init_ring(ring0);
    xw_init_ring(ring1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 feeds ring 0, warp 9 ring 1
    setmaxnreg_dec<XW_PRODUCER_REGS>();
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      for (int it = 0; it < n_tiles; ++it) {
        const int s0 = kv_lo + it * BN;  // keys past S arrive as zeros
        auto atom = [&](const CUtensorMap* map, int a) {
          feed.push([&](void* dst, uint64_t* bar) { tma_load_4d(dst, map, bar, 64 * a, kv, s0, b); }, XW_FWD_SLOT);
        };
        if (warp == 8) {
          for (int a = 0; a < A; ++a) {  // S; with STREAM qs's atom a beside K's (rows past T*G arrive as zeros)
            if (STREAM)
              feed.push([&](void* dst, uint64_t* bar) {
                tma_load_4d(dst, &kmap, bar, 64 * a, kv, s0, b);
                tma_load_3d(static_cast<unsigned char*>(dst) + XW_FWD_SLOT, &qmap, bar, 64 * a, r0, (int)blockIdx.y);
              });
            else
              atom(&kmap, a);
          }
          for (int a = ch.c0; a < ch.c0 + n0; ++a) atom(&vmap, a);  // warpgroup 0's P V
        } else {
          for (int a = ch.c0 + n0; a < ch.c1; ++a) atom(&vmap, a);  // warpgroup 1's P V
        }
      }
    }
    return;
  }
  setmaxnreg_inc<XW_CONSUMER_REGS>();

  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row (and row + 8) in the warp's 16; column pair
  auto mem = [&](int r) { return (size_t)(r / G) * H + r % G; };  // the (timestep, head) row of group row r
  const E* qb = q + ((size_t)b * T * H + kv * G) * D;
  E* ob = o + ((size_t)b * T * H + kv * G) * D;

  // both warpgroups stage the block's 64 rows as qs (rope_qs.cuh's bits), D / 16 pieces a row, each 8
  // columns of the low half and their partners D / 2 on; with STREAM xw_qs_kernel did
  if (!STREAM) {
    const int pieces = D / 16;
    const float qscale = scale * XW_LOG2E;
    for (int c = threadIdx.x; c < XW_ROWS * pieces; c += 256) {
      const int r = c / pieces, col = (c % pieces) * 8, row = r0 + r;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
      if (row < rows) {
        const size_t t = row / G;
        if (cos_t != nullptr)
          rope_qs8_half<true>(qb + mem(row) * D, cos_t + t * D, sin_t + t * D, col, D / 2, qscale, lo, hi);
        else
          rope_qs8_half<false>(qb + mem(row) * D, nullptr, nullptr, col, D / 2, qscale, lo, hi);
      }
      const int hcol = col + D / 2;
      *reinterpret_cast<uint4*>(Qs + (col / 64) * XW_ATOM + sw128(r, (col % 64) / 8)) = lo;
      *reinterpret_cast<uint4*>(Qs + (hcol / 64) * XW_ATOM + sw128(r, (hcol % 64) / 8)) = hi;
    }
  }
  fence_proxy_async();
  named_bar_sync(1, 256);

  const int row_a = r0 + (warp % 4) * 16 + g, row_b = row_a + 8;
  const size_t mem_a = mem(row_a), mem_b = mem(row_b);
  float inv[2];

  if (wg == 0) {
    XwTake rd{ring0, lane};
    // the keys each of the thread's two rows sees, vis_n of them from vis_lo on (none for a pad row)
    int vis_lo[2], vis_n[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = (i == 0 ? row_a : row_b) / G;
      const KeySpan seen = keys_seen(kf, local, w2, t, t);
      vis_lo[i] = seen.lo;
      vis_n[i] = max(seen.hi - seen.lo, 0);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[BN / 2];     // the logits of the tile in hand, then its probabilities
    uint32_t pa[F][4];   // its probabilities in E, the A operand of O += P V
    float acc[XW_FWD_ATOMS0][32];
    xw_zero(acc);
    for (int it = 0; it < n_tiles; ++it) {
      reg_fence(s);
      wgmma_fence();
      xw_dots<E, BN, STREAM>(s, Qs, A, rd);  // S = qs K^T, its atoms from the ring
      rd.drain();                    // and the previous tile's P V: pa and acc are free
      reg_fence(s);
      xw_fence(acc);
      reg_fence(pa);
      // the online softmax of the tile (flash_fwd.cuh's): mask at an edge, s becomes p = exp2(s - base)
      const int s0 = kv_lo + it * BN;
      const bool interior = s0 + BN <= kf.hi &&
                            (!local || (s0 - kf.off >= t_hi - w2 && s0 - kf.off + BN - 1 <= t_lo + w2));
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = s0 + i * 8 + 2 * tq + (e & 1);
            if ((unsigned)(key - vis_lo[e >> 1]) >= (unsigned)vis_n[e >> 1]) s[4 * i + e] = -INFINITY;
          }
      }
      float mx[2] = {m[0], m[1]}, base[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet stays at zero
        corr[r] = exp2_ftz(m[r] - base[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] = exp2_ftz(s[4 * i + e] - base[e >> 1]);
          rs[e >> 1] += s[4 * i + e];
        }
      }
      l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced at the end
      l[1] = l[1] * corr[1] + rs[1];
      xw_frags<E>(pa, s);
      xw_put_frags(xp + (it & 1) * 4 * F * 128, pa, tid);
      xc[((it & 1) * 2) * 128 + tid] = corr[0];
      xc[((it & 1) * 2 + 1) * 128 + tid] = corr[1];
      named_bar_sync(2, 256);  // P of tile it is in place; warpgroup 1 reads it before the next tile's barrier
#pragma unroll
      for (int i = 0; i < XW_FWD_ATOMS0; ++i)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[i][j] *= corr[(j >> 1) & 1];
      xw_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      xw_outer<E, XW_FWD_ATOMS0, BN>(acc, pa, n0, rd);  // O += P V over warpgroup 0's atoms
    }
    rd.drain();
    xw_fence(acc);
    reg_fence(pa);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
      xl[r * 128 + tid] = inv[r];
    }
    named_bar_sync(2, 256);  // 1 / l is in place
    if (lse != nullptr && tq == 0 && blockIdx.z == 0) {  // the 4 threads of a quad hold the same row statistics
      float* lb = lse + (size_t)b * T * H + kv * G;
      if (row_a < rows) lb[mem_a] = m[0] + log2f(l[0]);
      if (row_b < rows) lb[mem_b] = m[1] + log2f(l[1]);
    }
#pragma unroll
    for (int i = 0; i < XW_FWD_ATOMS0; ++i) {
      if (i >= n0) continue;
      const int c = (ch.c0 + i) * 64;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = c + 8 * t + 2 * tq;
        if (row_a < rows)
          *reinterpret_cast<uint32_t*>(ob + mem_a * D + col) = pack2<E>(acc[i][4 * t] * inv[0], acc[i][4 * t + 1] * inv[0]);
        if (row_b < rows)
          *reinterpret_cast<uint32_t*>(ob + mem_b * D + col) =
              pack2<E>(acc[i][4 * t + 2] * inv[1], acc[i][4 * t + 3] * inv[1]);
      }
    }
  } else {
    XwTake rd{ring1, lane};
    uint32_t pa[F][4];
    float acc[XW_FWD_ATOMS1][32];
    xw_zero(acc);
    for (int it = 0; it < n_tiles; ++it) {
      named_bar_sync(2, 256);  // warpgroup 0's P of tile it
      rd.drain();              // the previous tile's P V: pa and acc are free
      xw_fence(acc);
      reg_fence(pa);
      xw_get_frags(xp + (it & 1) * 4 * F * 128, pa, tid);
      const float corr[2] = {xc[((it & 1) * 2) * 128 + tid], xc[((it & 1) * 2 + 1) * 128 + tid]};
#pragma unroll
      for (int i = 0; i < XW_FWD_ATOMS1; ++i)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[i][j] *= corr[(j >> 1) & 1];
      xw_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      xw_outer<E, XW_FWD_ATOMS1, BN>(acc, pa, n1, rd);  // O += P V over warpgroup 1's atoms
    }
    rd.drain();
    xw_fence(acc);
    reg_fence(pa);
    named_bar_sync(2, 256);
    inv[0] = xl[tid];
    inv[1] = xl[128 + tid];
#pragma unroll
    for (int i = 0; i < XW_FWD_ATOMS1; ++i) {
      if (i >= n1) continue;
      const int c = (ch.c0 + n0 + i) * 64;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = c + 8 * t + 2 * tq;
        if (row_a < rows)
          *reinterpret_cast<uint32_t*>(ob + mem_a * D + col) = pack2<E>(acc[i][4 * t] * inv[0], acc[i][4 * t + 1] * inv[0]);
        if (row_b < rows)
          *reinterpret_cast<uint32_t*>(ob + mem_b * D + col) =
              pack2<E>(acc[i][4 * t + 2] * inv[1], acc[i][4 * t + 3] * inv[1]);
      }
    }
  }
}

// qs (B * Kv, T * G, D) in E, group-major (group row r of KV head kv: timestep
// r / G, head kv * G + r % G): the forward's qs above XW_MAX_D, rope_qs.cuh's
// bits as the staging above; eight columns of the low half and their
// partners a thread. q (B, T, H, D) raw, the tables (T, D) or null.
template <typename E>
__global__ void xw_qs_kernel(const E* __restrict__ q, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, E* __restrict__ qs, int B, int T, int H, int Kv, int D,
                             float qscale) {
  const int G = H / Kv, pieces = D / 16;
  const size_t n = (size_t)B * T * H * pieces;
  for (size_t c = blockIdx.x * (size_t)blockDim.x + threadIdx.x; c < n; c += (size_t)gridDim.x * blockDim.x) {
    const size_t row = c / pieces;  // (b, t, h) of q
    const int col = (int)(c % pieces) * 8, h = (int)(row % H);
    const size_t t = (row / H) % T, b = row / ((size_t)T * H);
    uint4 lo, hi;
    if (cos_t != nullptr)
      rope_qs8_half<true>(q + row * D, cos_t + t * D, sin_t + t * D, col, D / 2, qscale, lo, hi);
    else
      rope_qs8_half<false>(q + row * D, nullptr, nullptr, col, D / 2, qscale, lo, hi);
    E* dst = qs + ((b * Kv + h / G) * T * G + t * G + h % G) * D;
    *reinterpret_cast<uint4*>(dst + col) = lo;
    *reinterpret_cast<uint4*>(dst + col + D / 2) = hi;
  }
}

// ---- the backward pair ----

// dq_acc (group-major, fp32) (+)= ds k for the block's 64 group rows over
// the keys they see. grid (pad / 64, B * Kv).
template <typename E>
__global__ void __launch_bounds__(XW_THREADS, 1)
xwide_dq_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dq_acc,
                int T, int H, int Kv, int D, int pad, int window, KeyFrame kf, int accumulate, int slots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int A = D / 64;
  E* Qs = reinterpret_cast<E*>(smem);  // [A][64][64] qs
  E* Os = Qs + A * XW_ATOM;            // [A][64][64] do
  float* xp = reinterpret_cast<float*>(Os + A * XW_ATOM);     // [32][128] P, fp32
  uint32_t* xg = reinterpret_cast<uint32_t*>(xp + 32 * 128);  // [16][128] dS in E
  uint64_t* bars = reinterpret_cast<uint64_t*>(xg + 16 * 128);
  unsigned char* rings = smem + xw_dq_fixed(A);
  const XwRing ring0 = xw_ring(rings, bars, slots);
  const XwRing ring1 = xw_ring(rings + slots * XW_ATOM_BYTES, bars + 2 * XW_MAX_SLOTS, slots);
  uint64_t* row_bar = bars + 4 * XW_MAX_SLOTS;

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv, rows = T * G;
  const int r0 = blockIdx.x * XW_ROWS;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / G, t_hi = (min(r0 + XW_ROWS, rows) - 1) / G;
  const KeySpan span = keys_seen(kf, local, w2, t_lo, t_hi);
  const int kv_lo = span.lo;
  const int n_tiles = (span.hi - kv_lo + XW_ROWS - 1) / XW_ROWS;
  const int n0 = A / 2, n1 = A - n0;  // dq atoms of warpgroup 0 (the first), 1 (the rest)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    xw_init_ring(ring0);
    xw_init_ring(ring1);
    mbar_init(row_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 loads the rows and feeds ring 0, warp 9 ring 1
    setmaxnreg_dec<XW_PRODUCER_REGS>();
    if (lane == 0 && warp == 8) {
      mbar_expect_tx(row_bar, 2 * A * XW_ATOM_BYTES);
      for (int a = 0; a < A; ++a) {  // rows past T*G arrive as zeros
        tma_load_3d(Qs + a * XW_ATOM, &qmap, row_bar, 64 * a, r0, (int)grp);
        tma_load_3d(Os + a * XW_ATOM, &domap, row_bar, 64 * a, r0, (int)grp);
      }
    }
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      for (int it = 0; it < n_tiles; ++it) {
        const int s0 = kv_lo + it * XW_ROWS;  // keys past S arrive as zeros
        auto atom = [&](const CUtensorMap* map, int a) {
          feed.push([&](void* dst, uint64_t* bar) { tma_load_4d(dst, map, bar, 64 * a, kv, s0, b); });
        };
        if (warp == 8) {
          for (int a = 0; a < A; ++a) atom(&kmap, a);                // S
          for (int a = 0; a < n0; ++a) atom(&kmap, a);               // warpgroup 0's dQ += dS K
        } else {
          for (int a = 0; a < A; ++a) atom(&vmap, a);                // dP
          for (int a = n0; a < A; ++a) atom(&kmap, a);               // warpgroup 1's dQ += dS K
        }
      }
    }
    return;
  }
  setmaxnreg_inc<XW_CONSUMER_REGS>();

  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = r0 + (warp % 4) * 16 + g, row_b = row_a + 8;
  XwTake rd{wg == 0 ? ring0 : ring1, lane};
  float s[32];        // warpgroup 0: S, then P; 1: dP, then dS
  uint32_t ga[4][4];  // dS in E, the A operand of dQ += dS K
  float acc[XW_DQ_ATOMS][32];
  xw_zero(acc);
  const int mine = wg == 0 ? n0 : n1;
  mbar_wait(row_bar, 0);

  if (wg == 0) {
    // the rows' LSE (the scratch is padded to whole tiles, a pad row has +inf) and the keys each row sees
    const float lse_r[2] = {lse_g[grp * pad + row_a], lse_g[grp * pad + row_b]};
    int vis_lo[2], vis_n[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = (i == 0 ? row_a : row_b) / G;
      const KeySpan seen = keys_seen(kf, local, w2, t, t);
      vis_lo[i] = seen.lo;
      vis_n[i] = max(seen.hi - seen.lo, 0);
    }
    for (int it = 0; it < n_tiles; ++it) {
      reg_fence(s);
      wgmma_fence();
      xw_dots<E, 64>(s, Qs, A, rd);  // S = qs K^T
      rd.drain();
      reg_fence(s);
      xw_fence(acc);
      reg_fence(ga);
      const int s0 = kv_lo + it * XW_ROWS;
      const bool interior = s0 + XW_ROWS <= kf.hi &&
                            (!local || (s0 - kf.off >= t_hi - w2 && s0 - kf.off + XW_ROWS - 1 <= t_lo + w2));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(s[4 * i + e] - lse_r[e >> 1]);
          if (!interior) {
            const int key = s0 + i * 8 + 2 * tq + (e & 1);
            if ((unsigned)(key - vis_lo[e >> 1]) >= (unsigned)vis_n[e >> 1]) p = 0.f;
          }
          xp[(4 * i + e) * 128 + tid] = p;
        }
      named_bar_sync(2, 256);  // P is in place
      named_bar_sync(3, 256);  // warpgroup 1's dS is
      xw_get_frags(xg, ga, tid);
      reg_fence(ga);
      wgmma_fence();
      xw_outer<E, XW_DQ_ATOMS, 64>(acc, ga, n0, rd);  // dQ += dS K over warpgroup 0's atoms
    }
  } else {
    const float delta_r[2] = {delta_g[grp * pad + row_a], delta_g[grp * pad + row_b]};
    for (int it = 0; it < n_tiles; ++it) {
      reg_fence(s);
      wgmma_fence();
      xw_dots<E, 64>(s, Os, A, rd);  // dP = do V^T
      rd.drain();
      reg_fence(s);
      xw_fence(acc);
      reg_fence(ga);
      named_bar_sync(2, 256);  // P is in place
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = xp[i * 128 + tid] * (s[i] - delta_r[(i >> 1) & 1]);
      xw_frags<E>(ga, s);
      xw_put_frags(xg, ga, tid);
      named_bar_sync(3, 256);  // dS is in place; warpgroup 0 reads it before the next tile's first barrier
      reg_fence(ga);
      wgmma_fence();
      xw_outer<E, XW_DQ_ATOMS, 64>(acc, ga, n1, rd);  // dQ += dS K over warpgroup 1's atoms
    }
  }
  rd.drain();
  xw_fence(acc);
  reg_fence(ga);

  // each warpgroup stores (or adds) its atoms of the rows' dq, no scale: the forms post-pass applies it
  const int first = wg == 0 ? 0 : n0;
#pragma unroll
  for (int i = 0; i < XW_DQ_ATOMS; ++i) {
    if (i >= mine) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h == 0 ? row_a : row_b;
      if (row >= rows) continue;
      float* dst = dq_acc + (grp * pad + row) * D + (first + i) * 64 + 2 * tq;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float2 x = make_float2(acc[i][4 * t + 2 * h], acc[i][4 * t + 2 * h + 1]);
        float2* d2 = reinterpret_cast<float2*>(dst + 8 * t);
        if (accumulate) {
          const float2 old = *d2;
          x.x += old.x;
          x.y += old.y;
        }
        *d2 = x;
      }
    }
  }
}

// dk, dv (B, S, Kv, D) fp32, columns of the block's chunk, (+)= ln(2) ds^T
// qs, p^T do over the group rows that see the block's 64 keys; keys outside
// [kf.lo, kf.hi) get zeros. grid (ceil(S / 64), B * Kv, ceil(A / XW_DKV_ATOMS)).
template <typename E>
__global__ void __launch_bounds__(XW_THREADS, 1)
xwide_dkv_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int S, int H, int Kv, int D, int pad, int window, KeyFrame kf,
                 int accumulate, int slots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int A = D / 64;
  E* Ks = reinterpret_cast<E*>(smem);  // [A][64][64] k of the block's keys
  E* Vs = Ks + A * XW_ATOM;            // [A][64][64] v
  float* xp = reinterpret_cast<float*>(Vs + A * XW_ATOM);  // [2][32][128] P^T, fp32
  uint64_t* bars = reinterpret_cast<uint64_t*>(xp + 2 * 32 * 128);
  unsigned char* rings = smem + xw_dkv_fixed(A);
  const XwRing ring0 = xw_ring(rings, bars, slots);
  const XwRing ring1 = xw_ring(rings + slots * XW_ATOM_BYTES, bars + 2 * XW_MAX_SLOTS, slots);
  uint64_t* kv_bar = bars + 4 * XW_MAX_SLOTS;

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv;
  const int s0 = blockIdx.x * XW_ROWS;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const XwChunk ch = xw_chunk(A);
  const int n = ch.c1 - ch.c0;  // dk and dv atoms of the block
  // the block's keys that exist, [k_lo, k_hi], and the group rows whose window reaches them, [row_lo, row_hi),
  // from a whole tile on (the rows before the window are masked); no tile for a block with no key inside
  const int s_last = min(S, s0 + XW_ROWS) - 1;
  const int k_lo = max(s0, kf.lo), k_hi = min(s_last, kf.hi - 1);
  const int row_lo = local ? max(0, k_lo - kf.off - w2) * G / XW_ROWS * XW_ROWS : 0;
  const int row_hi = (local ? min(T, k_hi - kf.off + w2 + 1) : T) * G;
  const int n_tiles = k_lo <= k_hi ? (row_hi - row_lo + XW_ROWS - 1) / XW_ROWS : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (n_tiles <= 0) {  // no key of the block inside the song: zeros (nothing to add), no sweep
    if (!accumulate) {
      const int width = n * 64;
      for (int i = threadIdx.x; i < XW_ROWS * width / 4; i += XW_THREADS) {
        const int key = s0 + i / (width / 4);
        if (key >= S) continue;
        const size_t at = (((size_t)b * S + key) * Kv + kv) * D + ch.c0 * 64 + (i % (width / 4)) * 4;
        *reinterpret_cast<float4*>(dk + at) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    xw_init_ring(ring0);
    xw_init_ring(ring1);
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 loads k and v and feeds ring 0, warp 9 ring 1
    setmaxnreg_dec<XW_PRODUCER_REGS>();
    if (lane == 0 && warp == 8) {
      mbar_expect_tx(kv_bar, 2 * A * XW_ATOM_BYTES);
      for (int a = 0; a < A; ++a) {  // keys past S arrive as zeros
        tma_load_4d(Ks + a * XW_ATOM, &kmap, kv_bar, 64 * a, kv, s0, b);
        tma_load_4d(Vs + a * XW_ATOM, &vmap, kv_bar, 64 * a, kv, s0, b);
      }
    }
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      for (int it = 0; it < n_tiles; ++it) {
        const int r0 = row_lo + it * XW_ROWS;  // below pad: rows past T*G arrive as zeros, their lse is +inf
        auto atom = [&](const CUtensorMap* map, int a) {
          feed.push([&](void* dst, uint64_t* bar) { tma_load_3d(dst, map, bar, 64 * a, r0, (int)grp); });
        };
        if (warp == 8) {
          for (int a = 0; a < A; ++a) atom(&qmap, a);           // S^T
          for (int a = ch.c0; a < ch.c1; ++a) atom(&domap, a);  // dV += P^T do
        } else {
          for (int a = 0; a < A; ++a) atom(&domap, a);          // dP^T
          for (int a = ch.c0; a < ch.c1; ++a) atom(&qmap, a);   // dK += dS^T qs
        }
      }
    }
    return;
  }
  setmaxnreg_inc<XW_CONSUMER_REGS>();

  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, tq = lane & 3;
  const int key_a = s0 + (warp % 4) * 16 + g, key_b = key_a + 8;  // this thread's two keys
  const bool in_a = key_a >= kf.lo && key_a < kf.hi, in_b = key_b >= kf.lo && key_b < kf.hi;
  // the timesteps each key is seen from, [vis, vis + vis_n]: the window around its place on the queries'
  // diagonal; none for a key outside [kf.lo, kf.hi)
  const int vis_n = local ? 2 * w2 : INT_MAX;
  const int vis_a = !in_a ? 1 << 30 : local ? key_a - kf.off - w2 : 0;
  const int vis_b = !in_b ? 1 << 30 : local ? key_b - kf.off - w2 : 0;
  const bool keys_inside = s0 >= kf.lo && s0 + XW_ROWS <= kf.hi;
  XwTake rd{wg == 0 ? ring0 : ring1, lane};
  float s[32];        // warpgroup 0: S^T, then P^T; 1: dP^T, then dS^T (keys x the tile's rows)
  uint32_t fr[4][4];  // P^T or dS^T in E, the A operand of the kept product
  float acc[XW_DKV_ATOMS][32];  // warpgroup 0: dV; 1: dK (times ln 2 at the end)
  xw_zero(acc);
  const float* stat = (wg == 0 ? lse_g : delta_g) + grp * pad;
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = row_lo + it * XW_ROWS;
    reg_fence(s);
    wgmma_fence();
    xw_dots<E, 64>(s, wg == 0 ? Ks : Vs, A, rd);  // S^T = K qs^T or dP^T = V do^T
    // the tile's lse (warpgroup 0) or delta (1) at this thread's columns: rows r0 + 8 i + 2 tq, + 1
    float2 st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = *reinterpret_cast<const float2*>(stat + r0 + 8 * i + 2 * tq);
    rd.drain();
    reg_fence(s);
    xw_fence(acc);
    reg_fence(fr);
    float* pf = xp + (it & 1) * 32 * 128;
    if (wg == 0) {
      // p = exp2(s - lse2), zero outside the window and for a key outside [kf.lo, kf.hi); only a tile whose
      // timesteps touch the window's edge, or a block with such keys, is masked
      const int t_a = r0 / G, t_b = (r0 + XW_ROWS - 1) / G;
      const bool interior = keys_inside && (!local || (s_last - kf.off - t_a <= w2 && t_b - (s0 - kf.off) <= w2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[4 * i] = exp2_ftz(s[4 * i] - st[i].x);
        s[4 * i + 1] = exp2_ftz(s[4 * i + 1] - st[i].y);
        s[4 * i + 2] = exp2_ftz(s[4 * i + 2] - st[i].x);
        s[4 * i + 3] = exp2_ftz(s[4 * i + 3] - st[i].y);
        if (!interior) {
          const int row = r0 + 8 * i + 2 * tq;  // this thread's two columns: rows row, row + 1
          const int tx = row / G, ty = (row + 1) / G;
          if ((unsigned)(tx - vis_a) > (unsigned)vis_n) s[4 * i] = 0.f;
          if ((unsigned)(ty - vis_a) > (unsigned)vis_n) s[4 * i + 1] = 0.f;
          if ((unsigned)(tx - vis_b) > (unsigned)vis_n) s[4 * i + 2] = 0.f;
          if ((unsigned)(ty - vis_b) > (unsigned)vis_n) s[4 * i + 3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) pf[i * 128 + tid] = s[i];
      // P^T of tile it is in place; warpgroup 1 reads it before the next tile's barrier, and warpgroup 0
      // writes this buffer again two tiles on
      named_bar_sync(2, 256);
    } else {
      named_bar_sync(2, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[4 * i] = pf[(4 * i) * 128 + tid] * (s[4 * i] - st[i].x);
        s[4 * i + 1] = pf[(4 * i + 1) * 128 + tid] * (s[4 * i + 1] - st[i].y);
        s[4 * i + 2] = pf[(4 * i + 2) * 128 + tid] * (s[4 * i + 2] - st[i].x);
        s[4 * i + 3] = pf[(4 * i + 3) * 128 + tid] * (s[4 * i + 3] - st[i].y);
      }
    }
    xw_frags<E>(fr, s);
    reg_fence(fr);
    wgmma_fence();
    xw_outer<E, XW_DKV_ATOMS, 64>(acc, fr, n, rd);  // dV += P^T do or dK += dS^T qs over the chunk's atoms
  }
  rd.drain();
  xw_fence(acc);
  reg_fence(fr);

  // warpgroup 0 stores (or adds) dv, 1 dk (times ln 2); a key outside [kf.lo, kf.hi) gets zeros
  const float mul = wg == 0 ? 1.f : XW_LN2;
  float* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < XW_DKV_ATOMS; ++i) {
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h == 0 ? key_a : key_b;
      const bool in = h == 0 ? in_a : in_b;
      if (key >= S) continue;
      float* dst = out + (((size_t)b * S + key) * Kv + kv) * D + (ch.c0 + i) * 64 + 2 * tq;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float2 x = in ? make_float2(acc[i][4 * t + 2 * h] * mul, acc[i][4 * t + 2 * h + 1] * mul)
                      : make_float2(0.f, 0.f);
        float2* d2 = reinterpret_cast<float2*>(dst + 8 * t);
        if (accumulate) {
          const float2 old = *d2;
          x.x += old.x;
          x.y += old.y;
        }
        *d2 = x;
      }
    }
  }
}

// ---- host ----


inline bool xw_takes(int D) { return D >= XW_MIN_D && D <= XW_MAX_D && D % 64 == 0; }

// (D, rows, B * Kv) rows of E of a group-major (B * Kv, rows, D) buffer, boxes of 64 rows and one atom
template <typename E>
int xw_rows_map(CUtensorMap* map, const void* ptr, int rows, int groups, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, XW_ROWS, 1};
  return make_map<E>(map, 3, ptr, dims, strides, box);
}

template <typename E, bool STREAM>
int launch_xwide_fwd_kernel(const CUtensorMap& kmap, const CUtensorMap& vmap, const CUtensorMap& qmap, const void* q,
                            const void* cos_t, const void* sin_t, void* o, void* lse, int B, int T, int H, int Kv,
                            int D, int window, float scale, KeyFrame frame, int dev, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  const int err = allow_smem(xwide_fwd_kernel<E, STREAM>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const int A = D / 64, slot0 = STREAM ? XW_FWD_SLOT + XW_ATOM_BYTES : XW_FWD_SLOT;
  const int fixed = xw_fwd_fixed(STREAM ? 0 : A), slots = xw_slots2(fixed, slot0, XW_FWD_SLOT);
  const int per = XW_FWD_ATOMS0 + XW_FWD_ATOMS1;  // o atoms a block holds at most
  const dim3 grid((T * (H / Kv) + XW_ROWS - 1) / XW_ROWS, B * Kv, STREAM ? (A + per - 1) / per : 1);
  xwide_fwd_kernel<E, STREAM><<<grid, XW_THREADS, 1024 + fixed + slots * (slot0 + XW_FWD_SLOT),
                                static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, static_cast<const E*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<E*>(o), static_cast<float*>(lse), T, H, Kv, D, window, scale, frame, slots);
  return (int)cudaGetLastError();
}

// The forward at any head dim that is a multiple of 64: up to XW_MAX_D the
// block stages qs and holds it; above, xw_qs_kernel writes qs (group-major,
// into `qs`: (B * Kv, T * H / Kv, D) of E, unread below) and the forward
// streams it, its o columns in chunks on the grid's z axis
template <typename E>
int launch_xwide_fwd(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t, void* o,
                     void* lse, void* qs, int B, int T, int S, int H, int Kv, int D, int window, float scale,
                     KeyFrame frame, void* stream) {
  if (D <= 0 || D % 64 != 0 || (D > XW_MAX_D && qs == nullptr)) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap, qmap{};
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map<E>(&kmap, k, B, S, Kv, XW_FWD_KEYS, D);
  if (err == 0) err = make_kv_map<E>(&vmap, v, B, S, Kv, XW_FWD_KEYS, D);
  if (err != 0) return err;
  if (D <= XW_MAX_D)
    return launch_xwide_fwd_kernel<E, false>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse, B, T, H, Kv, D, window, scale,
                                             frame, dev, stream);
  const long long n = (long long)B * T * H * (D / 16);
  xw_qs_kernel<E><<<(unsigned)(n < 132LL * 64 * 256 ? (n + 255) / 256 : 132LL * 64), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<E*>(qs), B, T, H, Kv, D, scale * XW_LOG2E);
  err = (int)cudaGetLastError();
  if (err == 0) err = xw_rows_map<E>(&qmap, qs, T * (H / Kv), B * Kv, D);
  if (err != 0) return err;
  return launch_xwide_fwd_kernel<E, true>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse, B, T, H, Kv, D, window, scale,
                                          frame, dev, stream);
}

// The pair's tensor maps: k and v (B, S, Kv, D) in boxes of 64 keys, qs and do rows group-major
template <typename E>
int xw_pair_maps(CUtensorMap* maps, const void* k, const void* v, const void* qs_g, const void* do_rows, int B,
                 int T, int S, int H, int Kv, int D) {
  int err = make_kv_map<E>(&maps[0], k, B, S, Kv, XW_ROWS, D);
  if (err == 0) err = make_kv_map<E>(&maps[1], v, B, S, Kv, XW_ROWS, D);
  if (err == 0) err = xw_rows_map<E>(&maps[2], qs_g, T * (H / Kv), B * Kv, D);
  if (err == 0) err = xw_rows_map<E>(&maps[3], do_rows, T * (H / Kv), B * Kv, D);
  return err;
}

template <typename E>
int launch_xwide_dq(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
                    const void* delta_g, void* dq_acc, int B, int T, int S, int H, int Kv, int D, int pad, int window,
                    KeyFrame frame, int accumulate, void* stream) {
  if (!xw_takes(D) || pad % XW_ROWS != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const int A = D / 64;
  CUtensorMap maps[4];
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = xw_pair_maps<E>(maps, k, v, qs_g, do_rows, B, T, S, H, Kv, D);
  if (err == 0) err = allow_smem(xwide_dq_kernel<E>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const dim3 grid(pad / XW_ROWS, B * Kv);
  const int fixed = xw_dq_fixed(A), slots = xw_slots(fixed);
  xwide_dq_kernel<E><<<grid, XW_THREADS, 1024 + fixed + 2 * slots * XW_ATOM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dq_acc), T, H, Kv, D, pad, window, frame, accumulate, slots);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_xwide_dkv(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
                     const void* delta_g, void* dk, void* dv, int B, int T, int S, int H, int Kv, int D, int pad,
                     int window, KeyFrame frame, int accumulate, void* stream) {
  if (!xw_takes(D) || pad % XW_ROWS != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const int A = D / 64;
  CUtensorMap maps[4];
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = xw_pair_maps<E>(maps, k, v, qs_g, do_rows, B, T, S, H, Kv, D);
  if (err == 0) err = allow_smem(xwide_dkv_kernel<E>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const dim3 grid((S + XW_ROWS - 1) / XW_ROWS, B * Kv, (A + XW_DKV_ATOMS - 1) / XW_DKV_ATOMS);
  const int fixed = xw_dkv_fixed(A), slots = xw_slots(fixed);
  xwide_dkv_kernel<E><<<grid, XW_THREADS, 1024 + fixed + 2 * slots * XW_ATOM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, Kv, D, pad, window, frame, accumulate, slots);
  return (int)cudaGetLastError();
}

// the frame of a backward launch: one device ({0, 0, S}) or the halo slab of the shard (g0, t_global)
inline KeyFrame xw_frame(int halo, int T, int S, int window, int g0, int t_global) {
  return halo ? halo_frame(T, window, g0, t_global) : KeyFrame{0, 0, S};
}

}  // namespace
