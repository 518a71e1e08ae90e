// fp32 flash attention on the tensor cores, for Hopper (sm_90a): the forward
// at every head dim that is a multiple of 64 and the backward pair (dq,
// dk/dv) at D = 64 ... 512, every fp32 product as six bf16 wgmma products
// summed in fp32 (XLA's BF16_BF16_F32_X6), in place of flash_forms.cu's FMA
// bodies (forms_fwd_kernel<float, D, ROPE>, forms_dq_kernel<float, D>,
// forms_dkv_kernel<float, D> and the chunked forward
// forms_fwd_chunked_kernel<float, ROPE>, all deleted, and the chunked dq and
// dk/dv at fp32 up to 512, no longer built). The entry points are
// flash_f32x6.cu's.
//
// Replaces, at fp32 and those head dims,
// osufusion_tpu/ops/pallas_attention.py::
//  * _fwd_kernel (:208, launched by _flash_fwd), _halo_fwd_kernel (:938,
//    launched by _halo_flash_fwd) and one hop of _ring_fwd (:1310):
//    x6_fwd_kernel, windowed or global, MQA / GQA / full MHA (query head h
//    reads KV head h / (H / Kv)), fused q-RoPE or none, o and the base-2 LSE
//    in fp32, in the single-device or the halo frame (key_frame.cuh);
//  * _dq_kernel (:435), _halo_dq_kernel (:1054) and the dq part of
//    _bwd_fused_kernel (:575, also each hop of _ring_bwd :1338):
//    x6_dq_kernel;
//  * _dkv_kernel (:507), _halo_dkv_kernel (:1099) and the dk/dv part of
//    _bwd_fused_kernel: x6_dkv_kernel, which sums the G query heads of a KV
//    head.
// The pair reads the forms pre-pass's scratch (flash_forms.cu's
// forms_prep_kernel: qs in fp32, do in group-major order, the LSE and delta
// padded to 64-row tiles), and takes qs and do, and k and v, as their bf16
// pieces (x6_split, below); the forward takes k and v as their pieces and q
// raw, and stages qs itself with the pre-pass's bits (below; above D = 256
// x6_qs_kernel writes qs's pieces into device memory first). dq_acc, dk and
// dv are stored, or with `accumulate` added to (the ring's hops); the forms
// post-pass scales and un-rotates dq, as for the FMA bodies. Every forward
// wrapper at fp32, and every backward wrapper up to D = 512, runs them: one
// device, the ring's hops and sweeps, the windowed pair, the halo frame.
//
// The function is the FMA bodies' (flash_forms.cu at T = float):
//   forward: o = softmax2(qs k^T) v,  lse2 = log2 sum exp2(qs k^T)
//   dq_acc  (+)= ds k                 ds = p (do v^T - delta), p = exp2(qs k^T - lse2)
//   dk      (+)= ln(2) ds^T qs,  dv (+)= p^T do
// The arithmetic. Hopper has no full-fp32 tensor-core product (TF32 keeps 10
// bits of mantissa), so each fp32 value x is split exactly into three bf16
// pieces, x = b0 + b1 + b2 with b0 = rn(x), b1 = rn(x - b0), b2 = x - b0 - b1
// (8 + 8 + 8 bits of x's 24, each piece carrying its own sign, so b2 needs
// no rounding), and each fp32 product X Y becomes the six bf16 products
// X_i Y_j with i + j <= 2, accumulated in one fp32 accumulator. The terms
// left out (i + j >= 3) are below 2^-24 of the product, so the result is as
// exact as the fp32 arithmetic it replaces (5.8e-9 relative L2 against fp64
// on a 256 x 4096 x 256 product, fp32's own SGEMM 2.9e-7). The operands
// streamed through shared memory (k, v in the forward and dq; qs, do in
// dk/dv) are split once in device memory by x6_split_kernel, as rows [b0 |
// b1 | b2] of 3 D bf16; the forward splits its qs as it stages it (above 256
// x6_qs_kernel does, into rows of the same form); P and dS
// (P^T, dS^T) are split in registers, from the fp32 accumulator into the A
// fragments of wgmma (x6_frags). Per 64-column atom a of a product the
// six terms are issued as three groups, one per streamed piece, the small
// terms first: Y2 (X0 Y2), Y1 (X1 Y1, X0 Y1), then Y0 (X2 Y0, X1 Y0, X0 Y0).
// One level-two term (X2 Y0) follows a level-one term (X0 Y1); each addition
// rounds relative to the accumulator, which from the second atom on holds the
// whole sum of the atoms before, so the order costs nothing measurable
// (tests/test_torch_f32x6.py emulates it).
// X6 accumulation. On the H100 the error of a wgmma fp32 accumulator grows
// with the number of products added into it, about 1.3e-8 of the sum per
// 16-wide K step, as a rounding that is not to nearest would (dk and dv over
// 65536 rows, 24576 steps, read 3.1e-4 relative L2 against fp32; dq over 4096
// keys, 1536 steps, 2.6e-5), where fp32 FMAs rounding to nearest stay near
// 1e-7. So every accumulator of dq, dk and dv
// starts from zero each X6_FLUSH_TILES tiles and its sum goes to device
// memory (stored by the first flush of a launch that does not accumulate,
// added after by red.global.add, which rounds to nearest and does not wait),
// so that it takes at most 8 x 24 steps while it holds about 8 / n_tiles of
// the sum: the error is bounded by the flush period, not by the length of
// the song. The forward's O likewise: each X6_FLUSH_TILES tiles its
// accumulator goes to o in device memory, stored the first time and after
// added by fp32 FMA to what o holds rescaled to the softmax's current base
// (the product of the tiles' rescales since), and starts again from zero: on
// an H100, 24576 keys (384 tiles) read 3.5e-6 to 4.6e-6 relative L2 against
// fp32 at D = 64 and 256.
//
// Bound: compute, 6 x (4 D FLOP per visited (query, key) pair forward, 6 D
// in dq, 8 D in dk/dv) at the tensor cores' bf16 rate, 989 / 6 = 164.8
// TFLOP/s of fp32 work; a row meets up to W + 1 or S keys for a few kilobytes
// of traffic. Every 64-row block reads the keys it sees as three pieces, 12 D
// bytes a key for k and v (three times K1's bf16 traffic), mostly from L2.
//
// Design of the forward: flash_xwide.cuh's forward (two consumer warpgroups
// behind a producer warpgroup that feeds one ring of 64-column atoms to each,
// the head dim at run time), one instance per key tile: 128 keys up to D =
// X6_FWD_WIDE_MAX_D (1.12x / 1.07x faster than 64 at D = 64 / 128 on an
// H100), 64 above, where warpgroup 1's O and P's fragments of 128 keys would
// not fit its registers.
//  * Shared memory: the three pieces of the block's 64 rows of qs stay
//    resident, 3 x 2 x 64 x D bytes (24 / 48 / 72 / 96 KB at D = 64 / 128 /
//    192 / 256), staged by both consumer warpgroups from the raw q (rotated
//    and scaled with the forms pre-pass's bits, flash_forms.cu's qs_pair at
//    fp32, so that the backward recomputes the same logits), then split. k's
//    pieces stream through ring 0 and v's through ring 1, each atom of a
//    tile's keys and 64 columns in x6_feed_outer's order (piece 2, 1, 0): 5 /
//    4 slots of 16 KB a ring at D = 64 / 128, 8 / 6 of 8 KB at D = 192 / 256.
//  * Per tile: warpgroup 0 S = qs K^T in six products (x6_dots, qs's third
//    piece resident), the online softmax in the exp2 domain, and P in fp32
//    (with the rows' rescale) to warpgroup 1 through one buffer; warpgroup 1
//    splits P into its pieces' fragments and O[:, every atom] += P V
//    (x6_outer). Two named barriers a tile: P is in place, and (an arrive)
//    warpgroup 1 has read it; warpgroup 0 computes S of the next tile while
//    warpgroup 1 runs P V of this one.
//  * Registers (a consumer thread, of 240): warpgroup 0 S 64 or 32 and the
//    row statistics; warpgroup 1 O 2 x 32 with P's fragments of 128 keys 96,
//    or O 4 x 32 with those of 64 keys 48: 168 at launch, no spill.
// Above D = 256 (x6_fwd_res: RES = 1 or 0 of qs's pieces resident, in place of
// the three; tiles of 64 keys), what stops the design above:
//  * Shared memory. qs's three pieces take 3 x 2 x 64 x D bytes, 120 KB at
//    320 and 192 KB at 512. x6_qs_kernel writes them to device memory
//    (group-major rows [b0 | b1 | b2], the bits the staging holds), piece 0
//    is loaded by TMA and held (A atoms of 8 KB), and pieces 1 and 2 stream
//    through ring 0 beside k's, in x6_dots' order with RES = 1 (the pair's
//    issued_carry), the rings keeping X6_FWD_RES1_SLOTS slots or more (up to
//    D = 960). Above that piece 0 streams too (RES = 0): each of x6_dots'
//    three groups takes the X pieces it reads beside its Y piece (X0 three
//    times, X1 twice), groups of two, three and four atoms. Holding piece 0
//    pays: RES = 0 forced at D = 320 / 448 / 512 / 576 read 1.10 / 1.09 /
//    1.12 / 1.12x RES = 1's time (B=2, T=4096, H=16, MQA, global, tables, LSE;
//    chip_smoke.ab's forward, an H100 80GB HBM3 at 700 W).
//  * Registers. O's atoms no longer fit warpgroup 1 alone: warpgroup 0 takes
//    up to X6_FWD_ATOMS0 of them beside S and the softmax (its fragments of P
//    split from its own S, its O += P V issued after P is handed over and
//    done before the next tile's S, its flush before the next tile's S), and
//    warpgroup 1 up to X6_MAX_D / 64 as below. Four atoms on warpgroup 0
//    spilled 32 / 44 bytes (stores; 48 / 60 of loads) at RES = 0 / 1 on an
//    H100's ptxas (CUDA 12.8); three compile with no spill. So one block holds
//    7 atoms (D <= 448); above, the grid's z axis splits O's columns in chunks
//    of at most 7 atoms (xw_chunk: 4 + 4 at 512, 5 + 4 at 576, 6 + 6 + 4 at
//    1024), each chunk's block computing S again over the whole head dim;
//    only the block of chunk 0 writes the LSE.
//  * Every instance of the forward, narrow or wide, gets ptxas's C7520
//    (wgmma serialised by a compiler-inserted WG.AR in a divergent path: the
//    warpgroup branches), as the pair's x6_dq_kernel and flash_xwide.cuh's
//    kernels do; no C7512.
// Design of the pair: flash_xwide.cuh's pair (two consumer warpgroups behind a
// producer warpgroup that feeds one ring of 64-column atoms to each; the head
// dim at run time; its rings, XwRing / XwFeed, and helpers are used as they
// are), with three changes for the pieces:
//  * Shared memory. A 64-row tile of three pieces takes 3 x 2 x 64 x D bytes,
//    96 KB at D = 256, and the block keeps two such operands resident (qs and
//    do in dq, k and v in dk/dv): 192 KB, which leaves no room for the rings.
//    So only pieces 0 and 1 of the resident rows stay in shared memory (4 D / 64
//    atoms of 8 KB, 128 KB at D = 256), and piece 2 (X2) streams through the
//    ring each tile beside Y0, the group that needs it; the rings get the
//    rest: 11 / 9 / 7 / 5 slots each at D = 64 / 128 / 192 / 256.
//  * Groups of one or two atoms (X6Take): a group's atoms are released
//    together once the group after it is issued and the group itself is done,
//    so at most four atoms are held; five slots keep one group loading.
//  * The hand-overs stay fp32: P (P^T) crosses from warpgroup 0 to 1
//    unrounded, in dq dS crosses back over P in the same buffer (each thread
//    reads and writes only its own column of it), and each warpgroup splits
//    what it needs into its own fragments. In dk/dv one P^T buffer serves
//    both warpgroups: warpgroup 1 signals on barrier 4 once it has read it.
//  * Per tile of 64 keys (dq) or 64 rows (dk/dv):
//      dq:    warpgroup 0 S = qs K^T, P, to 1; 1 dP = do V^T and dS = P (dP -
//             delta), back to 0; both dQ[:, own atoms] += dS K (0 the first
//             ceil(A / 2) atoms, 1 the rest);
//      dk/dv: warpgroup 0 S^T = K qs^T, P^T, to 1, and dV += P^T do;
//             1 dP^T = V do^T, dS^T = P^T (dP^T - delta), dK += dS^T qs.
//  * Registers (a consumer thread, of 240): S or dP 32 + the three pieces'
//    fragments 48 + dQ at most 2 x 32, or dV or dK at most 4 x 32; in dk/dv
//    the fragments are done with before the next S^T or dP^T begins, and the
//    tile's LSE or delta is prefetched into L1 and read after the products,
//    so that neither takes registers beside them.
//  * Masks as in flash_xwide.cuh: only a tile at the window's edge or past
//    the keys that exist ([kf.lo, kf.hi)) is masked.
// Above D = 256 (x6_res: RES = 1 in place of 2, the same bodies):
//  * Shared memory. Two pieces of two resident operands take 4 D / 64 atoms,
//    160-256 KB: only piece 0 stays (80 / 96 / 112 / 128 KB at D = 320 / 384
//    / 448 / 512), and piece 1 (X1) streams through the ring too, after Y1
//    (x6_feed_dots). It is read by the group of Y1 and by that of Y0, so the
//    first group takes it and carries it into the second (X6Take::
//    issued_carry): at most four atoms stay held, and the rings get 8 / 7 /
//    6 / 5 slots each.
//  * Registers: dQ takes up to X6_DQ_WIDE_ATOMS = 4 atoms a warpgroup (S or
//    dP 32 + fragments 48 + 128); dK and dV keep 4 atoms a warpgroup (five
//    spilled 2288 bytes on an H100's ptxas), so the grid's z axis splits
//    their columns in two chunks (3 + 2, 3 + 3, 4 + 3, 4 + 4 atoms), each
//    chunk's block computing S^T and dP^T again: at most 2 / 3 of the bound.
//  * Traffic. A block streams each tile's pieces from L2: dq 13 D / 64 atoms
//    of 8 KB a 64-key tile, dk/dv 10 D / 64 + 6 n a 64-row tile, about 4.5
//    TB/s across the card at the measured speed. Loading the pieces that two
//    blocks share once into both, by TMA multicast in two-block clusters
//    (neighbouring row blocks in dq, the two column chunks in dk/dv), moved
//    dq by -4 % to +1 % and dk/dv by -6 % to +7 % on an H100: L2 is not what
//    holds the pair back, and the clusters are not used.
//
// C ABI (loaded with ctypes): f32x6_fwd and f32x6_halo_fwd take
// flash_xwide.cu's xwide_fwd_bf16's and xwide_halo_fwd_bf16's arguments (q
// and o fp32, k and v as their pieces, the scratch of qs's pieces above
// 256); f32x6_bwd_dq and f32x6_bwd_dkv take flash_forms.cu's forms_bwd_dq's
// and forms_bwd_dkv's arguments without the type code (the head dim first;
// k, v, qs_g and do_rows as their pieces); each returns a cudaError_t
// (cudaErrorInvalidValue for a head dim that is not a multiple of 64, the
// pair's also outside 64 ... 512, or the forward above 256 without its
// scratch), or minus the CUresult of a TMA descriptor that failed to encode;
// f32x6_split writes the pieces (every multiple of 64).
//
// Everything sits in an unnamed namespace, so each library gets its own copy.

#pragma once

#include "flash_xwide.cuh"

namespace {

constexpr int X6_MAX_D = 256;       // the forward's widest head dim that stages qs, the pair's with two resident pieces
constexpr int X6_PAIR_MAX_D = 512;  // the pair's widest
// dq atoms of either warpgroup at most: up to X6_MAX_D, and above it (where four atoms of dQ stand in registers
// beside S and the fragments: 128 + 32 + 48)
constexpr int X6_DQ_ATOMS = 2, X6_DQ_WIDE_ATOMS = 4;
// dk (and dv) atoms of a block: every atom up to X6_MAX_D; above it the grid's z axis splits them in chunks of
// at most this many (two chunks at D = 320 ... 512), each block recomputing S^T and dP^T
constexpr int X6_DKV_ATOMS = 4;
// the forward's tiles: 128 keys up to X6_FWD_WIDE_MAX_D (two atoms of O in warpgroup 1 beside P's fragments of
// 128 keys), 64 above (four atoms of O)
constexpr int X6_FWD_WIDE_MAX_D = 128;
// above X6_MAX_D the forward's O atoms of a block at most on warpgroup 0, beside S and the softmax (four spilled,
// below); warpgroup 1 holds X6_MAX_D / 64, and the grid's z axis splits wider heads in chunks of both, each block
// computing S again
constexpr int X6_FWD_ATOMS0 = 3;
constexpr int X6_SPLIT_THREADS = 256;
// tiles whose products a wgmma accumulator takes before its sum goes to device memory (X6 accumulation, below)
constexpr int X6_FLUSH_TILES = 8;

// ---- the split ----

// the three bf16 pieces of two neighbouring fp32 values, each pair packed in
// one register (x0 in the low half): b0 = rn(x), b1 = rn(x - b0), b2 = x - b0 -
// b1, whose subtractions are exact and b2 exact in bf16
__device__ __forceinline__ void x6_pieces2(float x0, float x1, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(x0, x1);
  const float2 h0 = __bfloat1622float2(b0);
  const float r0 = x0 - h0.x, r1 = x1 - h0.y;
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(r0, r1);
  const float2 h1 = __bfloat1622float2(b1);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(r0 - h1.x, r1 - h1.y);
  p0 = *reinterpret_cast<const uint32_t*>(&b0);
  p1 = *reinterpret_cast<const uint32_t*>(&b1);
  p2 = *reinterpret_cast<const uint32_t*>(&b2);
}

// the pieces of eight fp32 values as three 16-byte rows of eight bf16 (p[i]: piece i)
__device__ __forceinline__ void x6_pieces8(const float (&v)[8], uint4 (&p)[3]) {
  uint32_t w[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x6_pieces2(v[2 * e], v[2 * e + 1], w[0][e], w[1][e], w[2][e]);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
}

// x (n_rows, D) fp32 -> out (n_rows, 3 D) bf16, row [b0 | b1 | b2]: eight
// elements a thread, two 16-byte loads and three 16-byte stores
__global__ void x6_split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out, size_t n_rows, int D) {
  const size_t chunks = n_rows * (D / 8);
  for (size_t c = blockIdx.x * (size_t)X6_SPLIT_THREADS + threadIdx.x; c < chunks;
       c += (size_t)gridDim.x * X6_SPLIT_THREADS) {
    const size_t row = c / (D / 8);
    const int col = (int)(c % (D / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(x + row * D + col);
    const float4 lo = src[0], hi = src[1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint4 p[3];
    x6_pieces8(v, p);
    __nv_bfloat16* dst = out + row * 3 * D + col;
#pragma unroll
    for (int i = 0; i < 3; ++i) *reinterpret_cast<uint4*>(dst + i * D) = p[i];
  }
}

// the three pieces of a 64 x 16 F fp32 accumulator (one per thread: s[8 F])
// as the A fragments of F 16-wide K steps each, hopper.cuh's a_frag layout
template <int F>
__device__ __forceinline__ void x6_frags(uint32_t (&f)[3][F][4], const float (&s)[8 * F]) {
#pragma unroll
  for (int j = 0; j < F; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x6_pieces2(s[8 * j + 2 * e], s[8 * j + 2 * e + 1], f[0][j][e], f[1][j][e], f[2][j][e]);
}

template <int F>
__device__ __forceinline__ void x6_fence(uint32_t (&f)[3][F][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) reg_fence(f[i]);
}

// brings the 128-byte line at p into L1 (no register holds it)
__device__ __forceinline__ void x6_prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// *p (+)= x, y at two neighbouring floats: stored, or added by the L2's
// atomic units (rounding to nearest; no wait for the old value)
__device__ __forceinline__ void x6_put2(float* p, float x, float y, bool store) {
  if (store) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(x) : "memory");
    asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p + 1), "f"(y) : "memory");
  }
}

// arrive on named barrier `id` without waiting (the other side syncs on it)
__device__ __forceinline__ void x6_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- the consumer's side of a ring, in groups of one or two atoms ----

// A warpgroup takes the atoms of its ring in order, a product group reading
// the atoms taken since the last issued(); a group's atoms go back to the
// producer together, once the group after it is issued and it is done (two
// groups in flight, at most four atoms held)
struct X6Take {
  XwRing r;
  int lane;
  XwPos at;
  XwPos first;      // the first atom of the group being taken
  int taking = 0;   // its atoms so far
  XwPos held_at;    // the first atom of the last group issued, not yet released
  int held = 0;     // its atoms; 0: none
  // the next atom, once it has arrived
  __device__ __forceinline__ const void* take() {
    if (taking++ == 0) first = at;
    mbar_wait(&r.full[at.st], at.phase);
    const void* p = r.slots + at.st * r.bytes;
    at.advance(r.n);
    return p;
  }
  // after the group that reads the atoms taken is committed: the group before
  // it is done, so its atoms go back to the producer
  __device__ __forceinline__ void issued() {
    if (held > 0) {
      wgmma_wait<1>();
      release(held_at, held);
    }
    held_at = first;
    held = taking;
    taking = 0;
  }
  // issued() for a group of two atoms whose second (the resident rows' piece 1 above X6_MAX_D, which the next
  // group reads too) is carried into the next group, and goes back to the producer with it
  __device__ __forceinline__ void issued_carry() {
    if (held > 0) {
      wgmma_wait<1>();
      release(held_at, held);
    }
    held_at = first;
    held = 1;
    first.advance(r.n);  // the carried atom, the one after the group's first
    taking = 1;
  }
  // every group of the warpgroup is done and every atom released
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (held > 0) release(held_at, held);
    held = 0;
  }
  __device__ __forceinline__ void release(XwPos p, int n) {
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i < n; ++i) {
        mbar_arrive(&r.empty[p.st]);
        p.advance(r.n);
      }
  }
};

// The producer's order of one product's stream per atom a, the same for
// every product of a resident X and a streamed Y (X6Take's groups): Y2[a],
// Y1[a], X2[a], Y0[a] with RES = 2 of X's pieces resident; with RES = 1 X1[a]
// too, after Y1[a]. y(dst, bar, piece, a) and x(dst, bar, piece, a) load one
// atom.
template <int RES, typename LoadY, typename LoadX>
__device__ __forceinline__ void x6_feed_dots(XwFeed& feed, int A, LoadY y, LoadX x) {
  for (int a = 0; a < A; ++a) {
    if (RES == 0) {  // none of X's pieces resident: each group's X pieces stream beside its Y piece (x6_dots)
      feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 2, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 0, a); });
      feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 1, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 1, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 0, a); });
      feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 0, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 2, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 1, a); });
      feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 0, a); });
      continue;
    }
    feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 2, a); });
    feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 1, a); });
    if (RES == 1) feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 1, a); });
    feed.push([&](void* dst, uint64_t* bar) { x(dst, bar, 2, a); });
    feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, 0, a); });
  }
}

// With RES = 0: Y2[a], X0[a] | Y1[a], X1[a], X0[a] | Y0[a], X2[a], X1[a], X0[a],
// the three groups of x6_dots (X's pieces streamed once for each group that reads them).

// ... and of an outer product's over atoms [c0, c1): Y2[a], Y1[a], Y0[a]
template <typename LoadY>
__device__ __forceinline__ void x6_feed_outer(XwFeed& feed, int c0, int c1, LoadY y) {
  for (int a = c0; a < c1; ++a)
    for (int p = 2; p >= 0; --p) feed.push([&](void* dst, uint64_t* bar) { y(dst, bar, p, a); });
}

// S (64 x N, fp32; N = 64 or 128 rows of Y) = sum over the A atoms of X_a
// Y_a^T in six products,
// both K-major: X's first RES pieces resident (piece i of atom a at x01 + (i A
// + a) XW_ATOM), Y's three pieces from the ring in x6_feed_dots' order, and
// X's piece 2 of atom a where x2(a) says, taken just before Y0[a]: from the
// ring in the pair (x6_feed_dots' X2), resident in the forward. With RES = 1
// X's piece 1 comes from the ring too: read by the group of Y1 and by that of
// Y0, it is taken by the first and carried into the second (issued_carry), so
// that it stays until both are done (a wait for it outside a take, in its
// place, made ptxas serialise dk/dv's wgmma: C7520)
template <int N = 64, int RES = 2, typename PieceX2>
__device__ __forceinline__ void x6_dots(float (&s)[N / 2], const __nv_bfloat16* x01, int A, X6Take& rd,
                                        PieceX2 x2_of) {
  using E = __nv_bfloat16;
  for (int a = 0; a < A; ++a) {
    if (RES == 0) {  // every piece from the ring, in the same three groups and order of terms
      const uint64_t y2 = desc_kmajor(rd.take()), x0 = desc_kmajor(rd.take());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0 + 2 * kk, y2 + 2 * kk, a > 0 || kk > 0);
      wgmma_commit();
      rd.issued();
      const uint64_t y1 = desc_kmajor(rd.take()), x1 = desc_kmajor(rd.take()), x0b = desc_kmajor(rd.take());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x1 + 2 * kk, y1 + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0b + 2 * kk, y1 + 2 * kk, 1);
      wgmma_commit();
      rd.issued();
      const uint64_t y0 = desc_kmajor(rd.take()), x2 = desc_kmajor(rd.take()), x1b = desc_kmajor(rd.take()),
                     x0c = desc_kmajor(rd.take());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x2 + 2 * kk, y0 + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x1b + 2 * kk, y0 + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0c + 2 * kk, y0 + 2 * kk, 1);
      wgmma_commit();
      rd.issued();
      continue;
    }
    const uint64_t x0 = desc_kmajor(x01 + a * XW_ATOM);
    const uint64_t y2 = desc_kmajor(rd.take());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0 + 2 * kk, y2 + 2 * kk, a > 0 || kk > 0);
    wgmma_commit();
    rd.issued();
    const uint64_t y1 = desc_kmajor(rd.take());
    const uint64_t x1 = desc_kmajor(RES == 2 ? x01 + (A + a) * XW_ATOM : rd.take());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x1 + 2 * kk, y1 + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0 + 2 * kk, y1 + 2 * kk, 1);
    wgmma_commit();
    if (RES == 1)
      rd.issued_carry();  // X1[a] goes back with the next group, which reads it too
    else
      rd.issued();
    const uint64_t x2 = desc_kmajor(x2_of(a)), y0 = desc_kmajor(rd.take());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x2 + 2 * kk, y0 + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x1 + 2 * kk, y0 + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 0, E>(s, x0 + 2 * kk, y0 + 2 * kk, 1);
    wgmma_commit();
    rd.issued();
  }
}

// acc[i] (64 x 64 columns of the i-th atom, fp32) += X Y_i for the first n
// of the N atoms in six products: X (64 x 16 F) as its three pieces'
// fragments, Y_i's pieces (16 F rows of 64 columns) from the ring in
// x6_feed_outer's order, read MN-major (their rows are the reduction)
template <int N, int F>
__device__ __forceinline__ void x6_outer(float (&acc)[N][32], const uint32_t (&f)[3][F][4], int n, X6Take& rd) {
  using E = __nv_bfloat16;
  constexpr uint64_t K_STEP = 16 * 128 >> 4;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const uint64_t y2 = desc_mnmajor(rd.take());
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[0][j], y2 + j * K_STEP, 1);
      wgmma_commit();
      rd.issued();
      const uint64_t y1 = desc_mnmajor(rd.take());
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[1][j], y1 + j * K_STEP, 1);
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[0][j], y1 + j * K_STEP, 1);
      wgmma_commit();
      rd.issued();
      const uint64_t y0 = desc_mnmajor(rd.take());
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[2][j], y0 + j * K_STEP, 1);
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[1][j], y0 + j * K_STEP, 1);
#pragma unroll
      for (int j = 0; j < F; ++j) wgmma_rs_n64<1, E>(acc[i], f[0][j], y0 + j * K_STEP, 1);
      wgmma_commit();
      rd.issued();
    }
  }
}

// the shared memory before the two rings at A = D / 64 atoms: the first RES
// pieces of the two resident operands, the fp32 hand-over buffer, the barriers
__host__ __device__ constexpr int x6_fixed(int A, int RES) {
  return xw_align(2 * RES * A * XW_ATOM_BYTES + 32 * 128 * 4 + XW_BARS);
}
// the resident pieces at a head dim: two up to X6_MAX_D, one above
__host__ __device__ constexpr int x6_res(int D) { return D <= X6_MAX_D ? 2 : 1; }
static_assert(xw_slots(x6_fixed(X6_MAX_D / 64, 2)) >= 5 && xw_slots(x6_fixed(X6_PAIR_MAX_D / 64, 1)) >= 5,
              "each ring keeps a group loading beside four held atoms");
static_assert(X6_MAX_D / 64 <= 2 * X6_DQ_ATOMS && X6_PAIR_MAX_D / 64 <= 2 * X6_DQ_WIDE_ATOMS &&
                  X6_MAX_D / 64 <= X6_DKV_ATOMS && X6_PAIR_MAX_D / 64 <= 2 * X6_DKV_ATOMS,
              "dq keeps every column in one block, dk/dv in at most two chunks");

// ---- dq ----

// dq_acc (group-major, fp32) (+)= ds k for the block's 64 group rows over
// the keys they see. grid (pad / 64, B * Kv). kmap / vmap: the pieces of k
// and v (B, S, Kv, 3 D); qmap / domap: those of qs and do (B * Kv, rows, 3 D).
// RES (x6_res): the pieces of qs and do that stay in shared memory.
template <int RES>
__global__ void __launch_bounds__(XW_THREADS, 1)
x6_dq_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dq_acc, int T,
             int H, int Kv, int D, int pad, int window, KeyFrame kf, int accumulate, int slots) {
  using E = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int DQA = RES == 2 ? X6_DQ_ATOMS : X6_DQ_WIDE_ATOMS;
  const int A = D / 64;
  E* Qs = reinterpret_cast<E*>(smem);  // [RES pieces][A][64][64] qs
  E* Os = Qs + RES * A * XW_ATOM;      // [RES][A][64][64] do
  float* xp = reinterpret_cast<float*>(Os + RES * A * XW_ATOM);  // [32][128] P, then dS, fp32
  uint64_t* bars = reinterpret_cast<uint64_t*>(xp + 32 * 128);
  unsigned char* rings = smem + x6_fixed(A, RES);
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
  const int n0 = A - A / 2, n1 = A / 2;  // dq atoms of warpgroup 0 (the first), 1 (the rest)
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
      mbar_expect_tx(row_bar, 2 * RES * A * XW_ATOM_BYTES);
      for (int i = 0; i < RES; ++i)
        for (int a = 0; a < A; ++a) {  // rows past T*G arrive as zeros
          tma_load_3d(Qs + (i * A + a) * XW_ATOM, &qmap, row_bar, i * D + 64 * a, r0, (int)grp);
          tma_load_3d(Os + (i * A + a) * XW_ATOM, &domap, row_bar, i * D + 64 * a, r0, (int)grp);
        }
    }
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      const CUtensorMap* rows_map = warp == 8 ? &qmap : &domap;  // X1 and X2 of S (qs) or of dP (do)
      const CUtensorMap* keys_map = warp == 8 ? &kmap : &vmap;   // Y of S (k) or of dP (v)
      for (int it = 0; it < n_tiles; ++it) {
        const int s0 = kv_lo + it * XW_ROWS;  // keys past S arrive as zeros
        auto keys = [&](const CUtensorMap* map) {
          return [=](void* dst, uint64_t* bar, int p, int a) { tma_load_4d(dst, map, bar, p * D + 64 * a, kv, s0, b); };
        };
        x6_feed_dots<RES>(feed, A, keys(keys_map), [&](void* dst, uint64_t* bar, int p, int a) {
          tma_load_3d(dst, rows_map, bar, p * D + 64 * a, r0, (int)grp);
        });
        if (warp == 8)
          x6_feed_outer(feed, 0, n0, keys(&kmap));  // warpgroup 0's dQ += dS K
        else
          x6_feed_outer(feed, n0, A, keys(&kmap));  // warpgroup 1's
      }
    }
    return;
  }
  setmaxnreg_inc<XW_CONSUMER_REGS>();

  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = r0 + (warp % 4) * 16 + g, row_b = row_a + 8;
  X6Take rd{wg == 0 ? ring0 : ring1, lane};
  auto from_ring = [&](int) { return rd.take(); };  // the resident rows' third piece
  float s[32];            // warpgroup 0: S, then P; 1: dP, then dS
  uint32_t f[3][4][4];    // dS's pieces, the A operand of dQ += dS K
  float acc[DQA][32];
  xw_zero(acc);
  const int mine = wg == 0 ? n0 : n1, first = wg == 0 ? 0 : n0;
  // the rows' LSE (warpgroup 0) or delta (1) (the scratch is padded to whole tiles, a pad row has +inf and 0),
  // and the keys each row sees
  const float* stat = (wg == 0 ? lse_g : delta_g) + grp * pad;
  const float st[2] = {stat[row_a], stat[row_b]};
  int vis_lo[2], vis_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = (i == 0 ? row_a : row_b) / G;
    const KeySpan seen = keys_seen(kf, local, w2, t, t);
    vis_lo[i] = seen.lo;
    vis_n[i] = max(seen.hi - seen.lo, 0);
  }
  mbar_wait(row_bar, 0);

  bool stored = accumulate;  // whether dq_acc holds this launch's first sum (or, accumulating, the hops before)
  for (int it0 = 0; it0 < n_tiles; it0 += X6_FLUSH_TILES) {
    const int it1 = min(n_tiles, it0 + X6_FLUSH_TILES);
    for (int it = it0; it < it1; ++it) {
      reg_fence(s);
      wgmma_fence();
      x6_dots<64, RES>(s, wg == 0 ? Qs : Os, A, rd, from_ring);  // S = qs K^T (warpgroup 0) or dP = do V^T (1)
      rd.drain();
      reg_fence(s);
      xw_fence(acc);
      x6_fence(f);
      if (wg == 0) {
        const int s0 = kv_lo + it * XW_ROWS;
        const bool interior = s0 + XW_ROWS <= kf.hi &&
                              (!local || (s0 - kf.off >= t_hi - w2 && s0 - kf.off + XW_ROWS - 1 <= t_lo + w2));
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_ftz(s[4 * i + e] - st[e >> 1]);
            if (!interior) {
              const int key = s0 + i * 8 + 2 * tq + (e & 1);
              if ((unsigned)(key - vis_lo[e >> 1]) >= (unsigned)vis_n[e >> 1]) p = 0.f;
            }
            xp[(4 * i + e) * 128 + tid] = p;
          }
        named_bar_sync(2, 256);  // P is in place
        named_bar_sync(3, 256);  // warpgroup 1's dS is, over it
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = xp[i * 128 + tid];
      } else {
        named_bar_sync(2, 256);  // P is in place
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = xp[i * 128 + tid] * (s[i] - st[(i >> 1) & 1]);
          xp[i * 128 + tid] = s[i];
        }
        named_bar_sync(3, 256);  // dS is in place; warpgroup 0 reads it before it writes the next tile's P
      }
      x6_frags(f, s);
      x6_fence(f);
      wgmma_fence();
      x6_outer<DQA>(acc, f, mine, rd);  // dQ += dS K over the warpgroup's atoms
    }
    // the warpgroup's atoms of the rows' dq (no scale: the forms post-pass applies it) go to dq_acc, stored the
    // first time unless accumulating, added after; acc starts again from zero
    rd.drain();
    xw_fence(acc);
#pragma unroll
    for (int i = 0; i < DQA; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h == 0 ? row_a : row_b;
        float* dst = dq_acc + (grp * pad + row) * D + (first + i) * 64 + 2 * tq;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float x = acc[i][4 * t + 2 * h], y = acc[i][4 * t + 2 * h + 1];
          if (i < mine && row < rows) x6_put2(dst + 8 * t, x, y, !stored);
        }
      }
    stored = true;
    xw_zero(acc);
    xw_fence(acc);
  }
}

// ---- dk/dv ----

// dk, dv (B, S, Kv, D) fp32, columns of the block's chunk, (+)= ln(2) ds^T
// qs, p^T do over the group rows that see the block's 64 keys; keys outside
// [kf.lo, kf.hi) get zeros. grid (ceil(S / 64), B * Kv, ceil(A /
// X6_DKV_ATOMS)). Maps as x6_dq_kernel's; RES the pieces of k and v that stay
// in shared memory.
template <int RES>
__global__ void __launch_bounds__(XW_THREADS, 1)
x6_dkv_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dk,
              float* __restrict__ dv, int T, int S, int H, int Kv, int D, int pad, int window, KeyFrame kf,
              int accumulate, int slots) {
  using E = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int A = D / 64;
  E* Ks = reinterpret_cast<E*>(smem);  // [RES pieces][A][64][64] k of the block's keys
  E* Vs = Ks + RES * A * XW_ATOM;      // [RES][A][64][64] v
  float* xp = reinterpret_cast<float*>(Vs + RES * A * XW_ATOM);  // [32][128] P^T, fp32
  uint64_t* bars = reinterpret_cast<uint64_t*>(xp + 32 * 128);
  unsigned char* rings = smem + x6_fixed(A, RES);
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

  if (n_tiles <= 0) {  // no key of the block inside the song: zeros in the chunk (nothing to add), no sweep
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
      mbar_expect_tx(kv_bar, 2 * RES * A * XW_ATOM_BYTES);
      for (int i = 0; i < RES; ++i)
        for (int a = 0; a < A; ++a) {  // keys past S arrive as zeros
          tma_load_4d(Ks + (i * A + a) * XW_ATOM, &kmap, kv_bar, i * D + 64 * a, kv, s0, b);
          tma_load_4d(Vs + (i * A + a) * XW_ATOM, &vmap, kv_bar, i * D + 64 * a, kv, s0, b);
        }
    }
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      const CUtensorMap* keys_map = warp == 8 ? &kmap : &vmap;   // X1 and X2 of S^T (k) or of dP^T (v)
      const CUtensorMap* dots_map = warp == 8 ? &qmap : &domap;  // Y of S^T (qs) or of dP^T (do)
      const CUtensorMap* outer_map = warp == 8 ? &domap : &qmap;  // Y of dV (do) or of dK (qs)
      for (int it = 0; it < n_tiles; ++it) {
        const int r0 = row_lo + it * XW_ROWS;  // below pad: rows past T*G arrive as zeros, their lse is +inf
        auto rows = [&](const CUtensorMap* map) {
          return [=](void* dst, uint64_t* bar, int p, int a) { tma_load_3d(dst, map, bar, p * D + 64 * a, r0, (int)grp); };
        };
        x6_feed_dots<RES>(feed, A, rows(dots_map), [&](void* dst, uint64_t* bar, int p, int a) {
          tma_load_4d(dst, keys_map, bar, p * D + 64 * a, kv, s0, b);
        });
        x6_feed_outer(feed, ch.c0, ch.c1, rows(outer_map));
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
  X6Take rd{wg == 0 ? ring0 : ring1, lane};
  auto from_ring = [&](int) { return rd.take(); };  // the resident keys' third piece
  float s[32];           // warpgroup 0: S^T, then P^T; 1: dP^T, then dS^T (keys x the tile's rows)
  uint32_t f[3][4][4];   // P^T's or dS^T's pieces, the A operand of the kept product
  float acc[X6_DKV_ATOMS][32];  // warpgroup 0: dV; 1: dK (times ln 2 when it leaves), the chunk's atoms
  xw_zero(acc);
  mbar_wait(kv_bar, 0);

  bool stored = accumulate;  // whether dk / dv hold this launch's first sum (or, accumulating, the hops before)
  for (int it0 = 0; it0 < n_tiles; it0 += X6_FLUSH_TILES) {
    const int it1 = min(n_tiles, it0 + X6_FLUSH_TILES);
    for (int it = it0; it < it1; ++it) {
      const int r0 = row_lo + it * XW_ROWS;
      // the tile's lse (warpgroup 0) or delta (1), 64 rows in two lines, into L1 while the products run: read
      // after them, so that no register holds them beside the dK or dV accumulators at D = 256 (nor does the
      // pointer: the kernel's arguments sit in the constant bank)
      const float* stat = (wg == 0 ? lse_g : delta_g) + grp * pad + r0;
      if (lane < 2) x6_prefetch_l1(stat + 32 * lane);
      reg_fence(s);
      wgmma_fence();
      x6_dots<64, RES>(s, wg == 0 ? Ks : Vs, A, rd, from_ring);  // S^T = K qs^T or dP^T = V do^T
      rd.drain();
      reg_fence(s);
      xw_fence(acc);
      x6_fence(f);
      // this thread's columns of them: rows r0 + 8 i + 2 tq, + 1
      float2 st[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = *reinterpret_cast<const float2*>(stat + 8 * i + 2 * tq);
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
        if (it > 0) named_bar_sync(4, 256);  // warpgroup 1 has read the last tile's P^T
#pragma unroll
        for (int i = 0; i < 32; ++i) xp[i * 128 + tid] = s[i];
        named_bar_sync(2, 256);  // P^T of tile it is in place
      } else {
        named_bar_sync(2, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[4 * i] = xp[(4 * i) * 128 + tid] * (s[4 * i] - st[i].x);
          s[4 * i + 1] = xp[(4 * i + 1) * 128 + tid] * (s[4 * i + 1] - st[i].y);
          s[4 * i + 2] = xp[(4 * i + 2) * 128 + tid] * (s[4 * i + 2] - st[i].x);
          s[4 * i + 3] = xp[(4 * i + 3) * 128 + tid] * (s[4 * i + 3] - st[i].y);
        }
        if (it + 1 < n_tiles) x6_bar_arrive(4, 256);  // the buffer is free for the next tile's P^T
      }
      x6_frags(f, s);
      x6_fence(f);
      wgmma_fence();
      x6_outer<X6_DKV_ATOMS>(acc, f, n, rd);  // dV += P^T do or dK += dS^T qs over the chunk's atoms
      // the first group of the next tile's products would wait for these anyway (X6Take::issued); done here,
      // the fragments are free before S^T or dP^T takes its registers, so that at D = 256 the accumulators,
      // the fragments and S^T or dP^T are never live together
      rd.drain();
      x6_fence(f);
    }
    // dv (warpgroup 0) or dk (1) of the block's keys goes to device memory, stored the first time unless
    // accumulating (a key outside [kf.lo, kf.hi) gets zeros), added after; acc starts again from zero
    rd.drain();
    xw_fence(acc);
    const float mul = wg == 0 ? 1.f : XW_LN2;
    float* out = (wg == 0 ? dv : dk) + ((size_t)b * S * Kv + kv) * D + ch.c0 * 64 + 2 * tq;
#pragma unroll
    for (int i = 0; i < X6_DKV_ATOMS; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = h == 0 ? key_a : key_b;
        const bool in = h == 0 ? in_a : in_b;
        float* dst = out + (size_t)key * Kv * D + i * 64;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float x = in ? acc[i][4 * t + 2 * h] * mul : 0.f, y = in ? acc[i][4 * t + 2 * h + 1] * mul : 0.f;
          if (i < n && key < S && (in || !stored)) x6_put2(dst + 8 * t, x, y, !stored);
        }
      }
    stored = true;
    xw_zero(acc);
    xw_fence(acc);
  }
}

// ---- the forward ----

// qs's eight columns col .. col + 7 of the low half of the raw q row `qr` (fp32, D = 2 half wide) and their
// partners half on, the forms pre-pass's bits (flash_forms.cu's qs_pair at fp32: each product rounded alone):
// rotated with the tables' rows cr, sr (null: only scaled), times qscale
__device__ __forceinline__ void x6_qs16(const float* qr, const float* cr, const float* sr, int col, int half,
                                        float qscale, float (&lo)[8], float (&hi)[8]) {
  const float4 q4[4] = {*reinterpret_cast<const float4*>(qr + col), *reinterpret_cast<const float4*>(qr + col + 4),
                        *reinterpret_cast<const float4*>(qr + col + half),
                        *reinterpret_cast<const float4*>(qr + col + half + 4)};
  const float* a = reinterpret_cast<const float*>(q4);  // a[j] = q[col + j], a[8 + j] = q[col + half + j]
  if (cr != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo[j] = __fmul_rn(__fsub_rn(__fmul_rn(a[j], cr[col + j]), __fmul_rn(a[8 + j], sr[col + j])), qscale);
      hi[j] = __fmul_rn(__fadd_rn(__fmul_rn(a[8 + j], cr[col + half + j]), __fmul_rn(a[j], sr[col + half + j])),
                        qscale);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo[j] = __fmul_rn(a[j], qscale);
      hi[j] = __fmul_rn(a[8 + j], qscale);
    }
  }
}

// qs's pieces (B * Kv, T * G, 3 D) bf16, group-major rows [b0 | b1 | b2] (group
// row r of KV head kv: timestep r / G, head kv * G + r % G), for the forward
// above X6_MAX_D: x6_qs16's values, split. q (B, T, H, D) raw fp32, the tables
// (T, D) or null.
__global__ void x6_qs_kernel(const float* __restrict__ q, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ qs, int B, int T, int H,
                             int Kv, int D, float qscale) {
  const int G = H / Kv, chunks = D / 16;
  const size_t n = (size_t)B * T * H * chunks;
  for (size_t c = blockIdx.x * (size_t)X6_SPLIT_THREADS + threadIdx.x; c < n;
       c += (size_t)gridDim.x * X6_SPLIT_THREADS) {
    const size_t row = c / chunks;  // (b, t, h) of q
    const int col = (int)(c % chunks) * 8, h = (int)(row % H);
    const size_t t = (row / H) % T, b = row / ((size_t)T * H);
    float lo[8], hi[8];
    x6_qs16(q + row * D, cos_t == nullptr ? nullptr : cos_t + t * D, sin_t == nullptr ? nullptr : sin_t + t * D, col,
            D / 2, qscale, lo, hi);
    uint4 pl[3], ph[3];
    x6_pieces8(lo, pl);
    x6_pieces8(hi, ph);
    __nv_bfloat16* dst = qs + ((b * Kv + h / G) * T * G + t * G + h % G) * 3 * D;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      *reinterpret_cast<uint4*>(dst + i * D + col) = pl[i];
      *reinterpret_cast<uint4*>(dst + i * D + col + D / 2) = ph[i];
    }
  }
}

// the shared memory before the forward's two rings at A atoms, tiles of BN
// keys and RES of qs's pieces resident: those pieces, one tile's P in fp32,
// its rows' rescale, the rows' 1 / l, the barriers
__host__ __device__ constexpr int x6_fwd_fixed(int A, int BN, int RES) {
  return xw_align(RES * A * XW_ATOM_BYTES + (BN / 2) * 128 * 4 + 2 * 128 * 4 + 2 * 128 * 4 + XW_BARS);
}
// the pieces of qs that stay resident above X6_MAX_D: piece 0 where its atoms leave rings of
// X6_FWD_RES1_SLOTS slots (four held, one group loading), none above
constexpr int X6_FWD_RES1_SLOTS = 5, X6_FWD_RES0_SLOTS = 8;
__host__ __device__ constexpr int x6_fwd_res(int D) {
  return D <= X6_MAX_D ? 3 : xw_slots(x6_fwd_fixed(D / 64, 64, 1)) >= X6_FWD_RES1_SLOTS ? 1 : 0;
}
static_assert(xw_slots(x6_fwd_fixed(X6_MAX_D / 64, 64, 3)) >= 4 &&
                  xw_slots(x6_fwd_fixed(X6_FWD_WIDE_MAX_D / 64, 128, 3), 128 * 64 * 2) >= 4,
              "each ring keeps two atoms loading beside two held");
static_assert(x6_fwd_res(X6_PAIR_MAX_D) == 1 && xw_slots(x6_fwd_fixed(1, 64, 0)) >= X6_FWD_RES0_SLOTS,
              "piece 0 of qs stays resident up to D = 512 at least; without it, a group of four atoms loads beside "
              "the three and four of the two groups held");

// o (B, T, H, D) fp32 = softmax2(qs k^T) v over the keys the block's 64 group
// rows see, and lse (B, T*H) their base-2 LSE (null: none), in tiles of BN
// keys (64, or 128 up to ATOMS = 2 atoms of the head dim). kmap / vmap: the
// pieces of k and v (B, S, Kv, 3 D) in boxes of BN keys. grid (ceil(T*G /
// 64), B * Kv, column chunks); frame {0, 0, S} on one device, halo_frame in
// the halo slab. RES = 3 (D <= X6_MAX_D): q raw (B, T, H, D) fp32, staged here
// as qs (rotated with the tables cos_t, sin_t (T, D), or without them (null)
// only scaled) and its three pieces held; warpgroup 1 holds O, ATOMS atoms.
// RES = 1 or 0 (above): qmap holds qs's pieces (x6_qs_kernel, boxes of one
// atom of 64 rows), piece 0 resident (RES = 1) or none, the rest streamed
// through ring 0 beside k's pieces; O's atoms of the block's z chunk split
// over both warpgroups, X6_FWD_ATOMS0 at most on warpgroup 0 and ATOMS on 1.
template <int BN, int ATOMS, int RES>
__global__ void __launch_bounds__(XW_THREADS, 1)
x6_fwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap qmap, const float* __restrict__ q, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, float* __restrict__ o, float* __restrict__ lse, int T, int H, int Kv,
              int D, int window, float scale, KeyFrame kf, int slots) {
  using E = __nv_bfloat16;
  constexpr int F = BN / 16;                                 // 16-key steps of a tile: P's fragments a piece
  constexpr int FLUSH = X6_FLUSH_TILES * XW_ROWS / BN;       // tiles that O's accumulator takes (X6 accumulation)
  constexpr int ATOMS0 = RES == 3 ? 1 : X6_FWD_ATOMS0;       // warpgroup 0's O atoms (none with RES = 3)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int A = D / 64;
  E* Qs = reinterpret_cast<E*>(smem);                            // [RES pieces][A][64][64] qs
  float* xp = reinterpret_cast<float*>(Qs + RES * A * XW_ATOM);  // [BN / 2][128] P, fp32
  float* xc = xp + (BN / 2) * 128;                               // [2][128] O's rescale
  float* xl = xc + 2 * 128;                                      // [2][128] 1 / l
  uint64_t* bars = reinterpret_cast<uint64_t*>(xl + 2 * 128);
  unsigned char* rings = smem + x6_fwd_fixed(A, BN, RES);
  const XwRing ring0 = xw_ring(rings, bars, slots, BN * 64 * 2);
  const XwRing ring1 = xw_ring(rings + slots * BN * 64 * 2, bars + 2 * XW_MAX_SLOTS, slots, BN * 64 * 2);
  uint64_t* row_bar = bars + 4 * XW_MAX_SLOTS;

  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int G = H / Kv, rows = T * G;  // the group's rows: group row r is timestep r / G, head kv * G + r % G
  const int r0 = blockIdx.x * XW_ROWS;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / G, t_hi = (min(r0 + XW_ROWS, rows) - 1) / G;
  const KeySpan span = keys_seen(kf, local, w2, t_lo, t_hi);  // the keys the block's rows see
  const int kv_lo = span.lo;
  const int n_tiles = (span.hi - kv_lo + BN - 1) / BN;
  const XwChunk ch = xw_chunk(A);  // the block's O atoms [c0, c1): every atom with RES = 3
  const int n0 = RES == 3 ? 0 : max(0, ch.c1 - ch.c0 - ATOMS), n1 = ch.c1 - ch.c0 - n0;  // warpgroup 0's, 1's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    xw_init_ring(ring0);
    xw_init_ring(ring1);
    mbar_init(row_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 feeds ring 0 with k's pieces, warp 9 ring 1 with v's
    setmaxnreg_dec<XW_PRODUCER_REGS>();
    if (lane == 0 && warp == 8 && RES == 1) {  // piece 0 of the block's rows of qs (rows past T*G arrive as zeros)
      mbar_expect_tx(row_bar, A * XW_ATOM_BYTES);
      for (int a = 0; a < A; ++a) tma_load_3d(Qs + a * XW_ATOM, &qmap, row_bar, 64 * a, r0, (int)blockIdx.y);
    }
    if (lane == 0 && warp < 10) {
      XwFeed feed{warp == 8 ? ring0 : ring1};
      const CUtensorMap* map = warp == 8 ? &kmap : &vmap;
      for (int it = 0; it < n_tiles; ++it) {
        const int s0 = kv_lo + it * BN;  // keys past S arrive as zeros
        auto keys = [&](const CUtensorMap* m) {
          return [=](void* dst, uint64_t* bar, int p, int a) { tma_load_4d(dst, m, bar, p * D + 64 * a, kv, s0, b); };
        };
        if (RES == 3) {
          x6_feed_outer(feed, 0, A, keys(map));  // S (k's pieces as x6_dots takes them with qs resident), or P V
        } else if (warp == 8) {
          x6_feed_dots<RES>(feed, A, keys(&kmap), [&](void* dst, uint64_t* bar, int p, int a) {
            tma_load_3d(dst, &qmap, bar, p * D + 64 * a, r0, (int)blockIdx.y);
          });
          x6_feed_outer(feed, ch.c0, ch.c0 + n0, keys(&vmap));  // warpgroup 0's O += P V
        } else {
          x6_feed_outer(feed, ch.c0 + n0, ch.c1, keys(&vmap));  // warpgroup 1's
        }
      }
    }
    return;
  }
  setmaxnreg_inc<XW_CONSUMER_REGS>();

  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row (and row + 8) in the warp's 16; column pair
  auto mem = [&](int r) { return (size_t)(r / G) * H + r % G; };  // the (timestep, head) row of group row r
  float* ob = o + ((size_t)b * T * H + kv * G) * D;

  if (RES == 3) {
    // both warpgroups stage the block's 64 rows as the pieces of qs (x6_qs16), 8 columns of the low half and
    // their partners D / 2 on at a time; a pad row is zeros
    const float* qb = q + ((size_t)b * T * H + kv * G) * D;
    const int half = D / 2, chunks = D / 16;
    const float qscale = scale * XW_LOG2E;
    for (int c = threadIdx.x; c < XW_ROWS * chunks; c += 256) {
      const int r = c / chunks, col = (c % chunks) * 8, row = r0 + r;
      float lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.f;
      if (row < rows) {
        const size_t t = row / G;
        x6_qs16(qb + mem(row) * D, cos_t == nullptr ? nullptr : cos_t + t * D,
                sin_t == nullptr ? nullptr : sin_t + t * D, col, half, qscale, lo, hi);
      }
      uint4 pl[3], ph[3];
      x6_pieces8(lo, pl);
      x6_pieces8(hi, ph);
      const int hcol = col + half;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        *reinterpret_cast<uint4*>(Qs + (i * A + col / 64) * XW_ATOM + sw128(r, (col % 64) / 8)) = pl[i];
        *reinterpret_cast<uint4*>(Qs + (i * A + hcol / 64) * XW_ATOM + sw128(r, (hcol % 64) / 8)) = ph[i];
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 256);
  }

  const int row_a = r0 + (warp % 4) * 16 + g, row_b = row_a + 8;
  const size_t mem_a = mem(row_a), mem_b = mem(row_b);
  X6Take rd{wg == 0 ? ring0 : ring1, lane};
  // n atoms of acc (times `mul` per row) into the rows' o from atom c on, plus what o holds times held
  auto flush = [&](auto& acc, int n, int c, bool stored, const float (&held)[2], const float (&mul)[2]) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(acc[0])); ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h == 0 ? row_a : row_b;
        float* dst = ob + (h == 0 ? mem_a : mem_b) * D + (c + i) * 64 + 2 * tq;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (i >= n || row >= rows) continue;
          float2 x = make_float2(acc[i][4 * t + 2 * h], acc[i][4 * t + 2 * h + 1]);
          float2* d2 = reinterpret_cast<float2*>(dst + 8 * t);
          if (stored) {
            const float2 old = *d2;
            x.x = fmaf(old.x, held[h], x.x);
            x.y = fmaf(old.y, held[h], x.y);
          }
          *d2 = make_float2(x.x * mul[h], x.y * mul[h]);
        }
      }
  };
  const float one[2] = {1.f, 1.f};

  if (wg == 0) {  // S = qs K^T and the online softmax; P goes to warpgroup 1; above X6_MAX_D O += P V too
    // the keys each of the thread's two rows sees, vis_n of them from vis_lo on (none for a pad row)
    int vis_lo[2], vis_n[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = (i == 0 ? row_a : row_b) / G;
      const KeySpan seen = keys_seen(kf, local, w2, t, t);
      vis_lo[i] = seen.lo;
      vis_n[i] = max(seen.hi - seen.lo, 0);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[BN / 2];            // the logits of the tile in hand, then its probabilities
    uint32_t f[3][F][4];        // above X6_MAX_D: P's pieces, the A operand of O += P V
    float acc[ATOMS0][32];      // ... and O's atoms of warpgroup 0 (X6 accumulation, as warpgroup 1's below)
    float held[2] = {1.f, 1.f};
    bool stored = false;
    if (RES != 3) xw_zero(acc);
    if (RES == 1) mbar_wait(row_bar, 0);
    auto from_ring = [&](int) { return rd.take(); };  // qs's third piece above X6_MAX_D
    for (int it = 0; it < n_tiles; ++it) {
      if (RES != 3 && n0 > 0 && it > 0 && it % FLUSH == 0) {  // before S takes its registers (acc is done)
        flush(acc, n0, ch.c0, stored, held, one);
        xw_zero(acc);
        held[0] = held[1] = 1.f;
        stored = true;
      }
      reg_fence(s);
      wgmma_fence();
      if (RES == 3)
        x6_dots<BN>(s, Qs, A, rd, [&](int a) { return Qs + (2 * A + a) * XW_ATOM; });
      else
        x6_dots<BN, RES == 1 ? 1 : 0>(s, Qs, A, rd, from_ring);
      rd.drain();
      reg_fence(s);
      // the online softmax of the tile (flash_xwide.cuh's): mask at an edge, s becomes p = exp2(s - base)
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
      float mx[2] = {m[0], m[1]}, base[2], corr[2], rs[2] = {0.f, 0.f};
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
      for (int i = 0; i < BN / 2; ++i) {
        s[i] = exp2_ftz(s[i] - base[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced at the end
      l[1] = l[1] * corr[1] + rs[1];
      if (it > 0) named_bar_sync(3, 256);  // warpgroup 1 has read the last tile's P
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) xp[i * 128 + tid] = s[i];
      xc[tid] = corr[0];
      xc[128 + tid] = corr[1];
      named_bar_sync(2, 256);  // P of tile it is in place
      if (RES != 3 && n0 > 0) {  // O[:, warpgroup 0's atoms] += P V, done before the next tile's S
        held[0] *= corr[0];
        held[1] *= corr[1];
#pragma unroll
        for (int i = 0; i < ATOMS0; ++i)
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[i][j] *= corr[(j >> 1) & 1];
        x6_frags(f, s);
        x6_fence(f);
        xw_fence(acc);
        wgmma_fence();
        x6_outer<ATOMS0>(acc, f, n0, rd);
        rd.drain();  // f is free before the next tile's S takes its registers
        x6_fence(f);
        xw_fence(acc);
      }
    }
    float inv[2];
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
    if (RES != 3 && n0 > 0) flush(acc, n0, ch.c0, stored, held, inv);
    return;
  }

  // warpgroup 1: O += P V over its atoms, P split into its three pieces here. The accumulator takes at most
  // FLUSH tiles (X6 accumulation, above): then its sum goes to o in device memory (stored, or added to what o
  // holds rescaled to the current base: `held`, the product of the rescales since o was written)
  uint32_t f[3][F][4];  // P's pieces, the A operand of O += P V
  float acc[ATOMS][32];
  xw_zero(acc);
  float held[2] = {1.f, 1.f};
  bool stored = false;  // whether o holds an earlier part of the sum
  const int c1 = ch.c0 + n0;  // warpgroup 1's first atom
  for (int it = 0; it < n_tiles; ++it) {
    named_bar_sync(2, 256);  // warpgroup 0's P of tile it
    rd.drain();              // the previous tile's P V: f and acc are free
    xw_fence(acc);
    x6_fence(f);
    if (it > 0 && it % FLUSH == 0) {
      flush(acc, n1, c1, stored, held, one);
      xw_zero(acc);
      held[0] = held[1] = 1.f;
      stored = true;
    }
    const float corr[2] = {xc[tid], xc[128 + tid]};
#pragma unroll
    for (int j = 0; j < F; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x6_pieces2(xp[(8 * j + 2 * e) * 128 + tid], xp[(8 * j + 2 * e + 1) * 128 + tid], f[0][j][e], f[1][j][e],
                   f[2][j][e]);
    if (it + 1 < n_tiles) x6_bar_arrive(3, 256);  // the buffer is free for the next tile's P
    held[0] *= corr[0];
    held[1] *= corr[1];
#pragma unroll
    for (int i = 0; i < ATOMS; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[i][j] *= corr[(j >> 1) & 1];
    xw_fence(acc);
    x6_fence(f);
    wgmma_fence();
    x6_outer<ATOMS>(acc, f, n1, rd);  // O += P V
  }
  rd.drain();
  xw_fence(acc);
  x6_fence(f);
  named_bar_sync(2, 256);
  const float inv[2] = {xl[tid], xl[128 + tid]};
  flush(acc, n1, c1, stored, held, inv);
}

// ---- host ----

// the head dims of the pair and the split (the forward takes every multiple of 64)
inline bool x6_pair_takes(int D) { return D >= 64 && D <= X6_PAIR_MAX_D && D % 64 == 0; }

// The pair's tensor maps, over the pieces (rows of 3 D bf16): k and v (B, S, Kv, 3 D) in boxes of 64 keys, qs
// and do rows group-major (B * Kv, T * G, 3 D); boxes of one 64-column atom
inline int x6_maps(CUtensorMap* maps, const void* k, const void* v, const void* qs_g, const void* do_rows, int B,
                   int T, int S, int H, int Kv, int D) {
  using E = __nv_bfloat16;
  int err = make_kv_map<E>(&maps[0], k, B, S, Kv, XW_ROWS, 3 * D);
  if (err == 0) err = make_kv_map<E>(&maps[1], v, B, S, Kv, XW_ROWS, 3 * D);
  if (err == 0) err = xw_rows_map<E>(&maps[2], qs_g, T * (H / Kv), B * Kv, 3 * D);
  if (err == 0) err = xw_rows_map<E>(&maps[3], do_rows, T * (H / Kv), B * Kv, 3 * D);
  return err;
}

template <int BN, int ATOMS, int RES>
int launch_x6_fwd_tiles(const CUtensorMap& kmap, const CUtensorMap& vmap, const CUtensorMap& qmap, const void* q,
                        const void* cos_t, const void* sin_t, void* o, void* lse, int B, int T, int H, int Kv, int D,
                        int window, float scale, KeyFrame frame, int dev, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const int err = allow_smem(x6_fwd_kernel<BN, ATOMS, RES>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const int A = D / 64, fixed = x6_fwd_fixed(A, BN, RES), slots = xw_slots(fixed, BN * 64 * 2);
  const int per = RES == 3 ? A : X6_FWD_ATOMS0 + ATOMS;  // O atoms a block holds at most
  x6_fwd_kernel<BN, ATOMS, RES><<<dim3((T * (H / Kv) + XW_ROWS - 1) / XW_ROWS, B * Kv, (A + per - 1) / per),
                                  XW_THREADS, 1024 + fixed + 2 * slots * BN * 64 * 2,
                                  static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, static_cast<const float*>(q), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(o), static_cast<float*>(lse), T, H, Kv, D, window, scale,
      frame, slots);
  return (int)cudaGetLastError();
}

// The forward at any head dim that is a multiple of 64. Above X6_MAX_D
// x6_qs_kernel first writes qs's pieces into `qs` ((B * Kv, T * H / Kv, 3 D)
// bf16; unread below), which the forward reads by TMA.
inline int launch_x6_fwd(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t, void* o,
                         void* lse, void* qs, int B, int T, int S, int H, int Kv, int D, int window, float scale,
                         KeyFrame frame, void* stream) {
  if (D <= 0 || D % 64 != 0 || (D > X6_MAX_D && qs == nullptr)) return (int)cudaErrorInvalidValue;
  const int keys = D <= X6_FWD_WIDE_MAX_D ? 128 : 64;
  CUtensorMap kmap, vmap, qmap{};
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map<__nv_bfloat16>(&kmap, k, B, S, Kv, keys, 3 * D);
  if (err == 0) err = make_kv_map<__nv_bfloat16>(&vmap, v, B, S, Kv, keys, 3 * D);
  if (err != 0) return err;
  if (D <= X6_MAX_D)
    return keys == 128 ? launch_x6_fwd_tiles<128, X6_FWD_WIDE_MAX_D / 64, 3>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse,
                                                                            B, T, H, Kv, D, window, scale, frame, dev,
                                                                            stream)
                       : launch_x6_fwd_tiles<64, X6_MAX_D / 64, 3>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse, B, T, H,
                                                                   Kv, D, window, scale, frame, dev, stream);
  const long long n = (long long)B * T * H * (D / 16);
  x6_qs_kernel<<<(unsigned)(n < 132LL * 64 * X6_SPLIT_THREADS ? (n + X6_SPLIT_THREADS - 1) / X6_SPLIT_THREADS
                                                              : 132LL * 64),
                 X6_SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(qs), B, T, H, Kv, D, scale * XW_LOG2E);
  err = (int)cudaGetLastError();
  if (err == 0) err = xw_rows_map<__nv_bfloat16>(&qmap, qs, T * (H / Kv), B * Kv, 3 * D);
  if (err != 0) return err;
  return x6_fwd_res(D) == 1 ? launch_x6_fwd_tiles<64, X6_MAX_D / 64, 1>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse, B,
                                                                        T, H, Kv, D, window, scale, frame, dev, stream)
                            : launch_x6_fwd_tiles<64, X6_MAX_D / 64, 0>(kmap, vmap, qmap, q, cos_t, sin_t, o, lse, B,
                                                                        T, H, Kv, D, window, scale, frame, dev, stream);
}

template <int RES>
int launch_x6_dq_res(const CUtensorMap (&maps)[4], const void* lse_g, const void* delta_g, void* dq_acc, int B, int T,
                     int H, int Kv, int D, int pad, int window, KeyFrame frame, int accumulate, int dev, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const int err = allow_smem(x6_dq_kernel<RES>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const int fixed = x6_fixed(D / 64, RES), slots = xw_slots(fixed);
  x6_dq_kernel<RES><<<dim3(pad / XW_ROWS, B * Kv), XW_THREADS, 1024 + fixed + 2 * slots * XW_ATOM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dq_acc), T, H, Kv, D, pad, window, frame, accumulate, slots);
  return (int)cudaGetLastError();
}

inline int launch_x6_dq(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
                        const void* delta_g, void* dq_acc, int B, int T, int S, int H, int Kv, int D, int pad,
                        int window, KeyFrame frame, int accumulate, void* stream) {
  if (!x6_pair_takes(D) || pad % XW_ROWS != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = x6_maps(maps, k, v, qs_g, do_rows, B, T, S, H, Kv, D);
  if (err != 0) return err;
  return x6_res(D) == 2
             ? launch_x6_dq_res<2>(maps, lse_g, delta_g, dq_acc, B, T, H, Kv, D, pad, window, frame, accumulate, dev, stream)
             : launch_x6_dq_res<1>(maps, lse_g, delta_g, dq_acc, B, T, H, Kv, D, pad, window, frame, accumulate, dev, stream);
}

template <int RES>
int launch_x6_dkv_res(const CUtensorMap (&maps)[4], const void* lse_g, const void* delta_g, void* dk, void* dv, int B,
                      int T, int S, int H, int Kv, int D, int pad, int window, KeyFrame frame, int accumulate, int dev,
                      void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const int err = allow_smem(x6_dkv_kernel<RES>, XW_SMEM_LIMIT, dev, smem_set);
  if (err != 0) return err;
  const int A = D / 64, fixed = x6_fixed(A, RES), slots = xw_slots(fixed);
  x6_dkv_kernel<RES><<<dim3((S + XW_ROWS - 1) / XW_ROWS, B * Kv, (A + X6_DKV_ATOMS - 1) / X6_DKV_ATOMS), XW_THREADS,
                       1024 + fixed + 2 * slots * XW_ATOM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, Kv, D, pad, window, frame, accumulate, slots);
  return (int)cudaGetLastError();
}

inline int launch_x6_dkv(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
                         const void* delta_g, void* dk, void* dv, int B, int T, int S, int H, int Kv, int D, int pad,
                         int window, KeyFrame frame, int accumulate, void* stream) {
  if (!x6_pair_takes(D) || pad % XW_ROWS != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = x6_maps(maps, k, v, qs_g, do_rows, B, T, S, H, Kv, D);
  if (err != 0) return err;
  return x6_res(D) == 2 ? launch_x6_dkv_res<2>(maps, lse_g, delta_g, dk, dv, B, T, S, H, Kv, D, pad, window, frame,
                                               accumulate, dev, stream)
                        : launch_x6_dkv_res<1>(maps, lse_g, delta_g, dk, dv, B, T, S, H, Kv, D, pad, window, frame,
                                               accumulate, dev, stream);
}

inline int launch_x6_split(const void* x, void* out, long long n_rows, int D, void* stream) {
  if (D <= 0 || D % 64 != 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const long long chunks = n_rows * (D / 8);
  const unsigned blocks = (unsigned)(chunks < 132LL * 64 * X6_SPLIT_THREADS ? (chunks + X6_SPLIT_THREADS - 1) / X6_SPLIT_THREADS
                                                                           : 132LL * 64);
  x6_split_kernel<<<blocks, X6_SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), (size_t)n_rows, D);
  return (int)cudaGetLastError();
}

}  // namespace
