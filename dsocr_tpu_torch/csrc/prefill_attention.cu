// Decoder prefill attention over the prompt's own K/V.
//
// Replaces flash_prefill_attention (dsocr_tpu/ops/pallas/prefill_attention.py:69):
// scores q·kᵀ·scale in f32, the mask kv <= q and kv >= pad_start[b] with a
// finite -1e30 fill (a fully masked, left-pad row is the uniform mean of v
// over all S keys), an f32 softmax and value sum, GQA through
// h / (H / Hkv).
//
// What bounds it on the H100: the bf16 tensor cores and the memory about
// alike. A (row, head) at S keys does 2·S²·D FLOPs under the causal mask
// (two products over the lower triangle) on 4·S·D elements of q, k, v and
// out: ~256 FLOPs per byte at S 1024, D 128, near the card's ~295 (989
// TFLOP/s over 3.35 TB/s); operations bound it at longer prompts.
//
// The bf16 kernel (prefill_attention_kernel, below):
// - Hopper wgmma for both products: S = Q·Kᵀ (m64n64k16) and O += P·V
//   (m64n128k16), bf16 in, f32 accumulators in registers. A block owns 128
//   queries of one (row, head): two warpgroups (4 warps each) of 64 rows
//   share its K/V tiles. The A operands (Q, then P) come from registers,
//   each warp holding its 16 rows; B (K, then V) is read by the tensor
//   cores from shared memory, laid out in the 128-byte swizzle and
//   addressed by matrix descriptors (V with the transpose flag), so no K or
//   V fragment passes through the registers.
// - The online softmax runs on the S fragments in registers, in log2
//   units (ex2 with log2 e folded into the scale): a row's max and sum are
//   taken across the 4 threads that hold it by shuffles, and no score
//   reaches shared memory. P is rounded to bf16 for the P·V product; l sums
//   the unrounded f32 p.
// - A ring of three K/V stages in shared memory, filled by cp.async (16
//   bytes a thread, each thread one fixed piece of fixed rows, so the
//   addresses are worked out once) with one barrier per tile: tiles j + 1
//   and j + 2 are in flight during the math of tile j. Q's fragments are
//   loaded once, from device memory straight into registers.
// - Dead tiles skipped, exactly: a warpgroup's rows [q0, q0 + 64) with
//   q0 >= pad_start[b] take only the key tiles from floor(pad_start / 64)
//   to their diagonal tile, and mask only boundary tiles. Every skipped
//   entry is -1e30 and weighs exp(-1e30 - m) = 0 for a row with a live
//   key. Rows that hold a fully masked one (q0 < pad_start, left padding
//   only) walk all S keys, as the reference's uniform mean needs.
// - Head dims below 128 are zero-padded to 128 in shared memory and in
//   Q's registers: zero columns add exactly 0, so one layout and one
//   instance serve every D, Dv <= 128 (the main path's are 128).
// - No atomics: two launches give the same bits.
// The heaviest query tiles (the last, with the most key tiles) start
// first. Overlapping the next tile's scores with this tile's softmax
// (FlashAttention-3's in-warpgroup pipelining) measured slower here (254
// registers, and the ring's refill has to wait for P·V): see PERF.md.
// One warpgroup a block is faster at B 1 (twice the blocks on 132 SMs)
// and slower at the serving wave's B 16, the main path.
//
// f32 inputs (the tiny parity configs, not the main path) run the CUDA-core
// f32 body of flash_tile.cuh: plain TF32 tensor cores would not meet the
// f32 tolerance.
#include "flash_tile.cuh"
#include "wgmma.cuh"

namespace dsocr {

constexpr int PF_WG = 2;        // warpgroups per block, 64 query rows each
constexpr int PF_BQ = 64 * PF_WG;
constexpr int PF_BK = 64;
constexpr int PF_STAGES = 3;   // the K/V ring: two tiles in flight during the math of one
constexpr int PF_THREADS = 128 * PF_WG;
constexpr int PF_DMAX = 128;
constexpr int PF_TILE = PF_BK * PF_DMAX;  // elements of one K or V stage

struct PrefillParams {
  const __nv_bfloat16* q;  // [B, H, S, D]
  const __nv_bfloat16* k;  // [B, Hkv, S, D]
  const __nv_bfloat16* v;  // [B, Hkv, S, Dv]
  __nv_bfloat16* out;      // [B, S, H * Dv]
  const int32_t* pad_start;  // [B]
  int B, H, Hkv, S, D, Dv;
  float scale;
  int vec;  // rows of D and Dv elements copy in 16-byte pieces
};

constexpr size_t prefill_smem_bytes() {
  return sizeof(__nv_bfloat16) * PF_STAGES * 2 * (size_t)PF_TILE;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d (64 × 64, f32; this warp's 16 rows, in mma.m16n8k16 C fragments) +=
// a (64 × 16, bf16; this warp's 16 rows in registers, mma A fragments) ·
// b (16 × 64, bf16, K-major in shared memory, descriptor)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 × 128, f32; this warp's 16 rows in 16 C fragments) += a (64 × 16,
// bf16, registers) · b (16 × 128, bf16, MN-major in shared memory: the
// descriptor's layout is read transposed)
__device__ __forceinline__ void wgmma_m64n128k16_tb(float (&d)[16][4], const unsigned (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Grid (H, B, query tiles), the last query tile (the one that visits the
// most key tiles) first. The block's warpgroups share the K/V ring; each
// owns 64 query rows (each warp 16) and computes only on the key tiles
// its own rows need.
__global__ void __launch_bounds__(PF_THREADS) prefill_attention_kernel(PrefillParams p) {
  extern __shared__ __align__(1024) unsigned char pf_smem[];
  const int S = p.S, D = p.D, Dv = p.Dv;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(pf_smem);  // STAGES × [64][128]
  __nv_bfloat16* v_s = k_s + PF_STAGES * PF_TILE;                    // STAGES × [64][128]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * PF_BQ;
  const int hk = h / (p.H / p.Hkv);
  const __nv_bfloat16* q = p.q + (size_t)(b * p.H + h) * S * D;
  const __nv_bfloat16* k = p.k + (size_t)(b * p.Hkv + hk) * S * D;
  const __nv_bfloat16* v = p.v + (size_t)(b * p.Hkv + hk) * S * Dv;
  const int pad = p.pad_start[b];
  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const int wq0 = q0 + 64 * (tid / 128);  // this warpgroup's first query row
  // scores in log2 units: 2^(s·log2e - m) = e^(s - m'), the mask fill too
  const float scale2 = p.scale * 1.4426950408889634f;
  const float masked2 = FT_MASKED * 1.4426950408889634f;

  // key tiles [kt0, kt1]: from the pad's tile to the diagonal's, or all;
  // the block's range, and [wkt0, wkt1], this warpgroup's
  const bool full = q0 < pad;  // the block holds a fully masked query row
  const int kt0 = full ? 0 : max(pad, 0) / PF_BK;
  const int kt1 = full ? (S - 1) / PF_BK : (min(q0 + PF_BQ, S) - 1) / PF_BK;
  const bool wfull = wq0 < pad;
  const int wkt0 = wfull ? 0 : max(pad, 0) / PF_BK;
  const int wkt1 = wq0 >= S ? -1 : wfull ? (S - 1) / PF_BK : (min(wq0 + 64, S) - 1) / PF_BK;

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // head columns past D (K) and Dv (V) are 0 in every stage
  for (int idx = tid; idx < PF_STAGES * PF_BK * (PF_DMAX - D); idx += PF_THREADS) {
    const int r = idx / (PF_DMAX - D), c = D + idx % (PF_DMAX - D);
    k_s[(r / PF_BK) * PF_TILE + sw128_off(r % PF_BK, c)] = zero;
  }
  for (int idx = tid; idx < PF_STAGES * PF_BK * (PF_DMAX - Dv); idx += PF_THREADS) {
    const int r = idx / (PF_DMAX - Dv), c = Dv + idx % (PF_DMAX - Dv);
    v_s[(r / PF_BK) * PF_TILE + sw128_off(r % PF_BK, c)] = zero;
  }
  // rows row0 .. row0 + 63 of src [S][width] into a stage; rows at or past
  // S are zeros (their weight is 0, and 0 · garbage could be NaN). 8
  // neighbouring threads take one 16-byte piece of 8 rows. On the main
  // path (width 128) each thread copies one fixed piece of the rows
  // lr + RSTEP j: its offsets are worked out once.
  constexpr int RSTEP = PF_THREADS / 16;
  const int lr = (tid / 128) * 8 + tid % 8, lc = (tid / 8 % 16) * 8;
  const int loff = sw128_off(lr, lc);  // + RSTEP · 64 a step: lr % 8 is the swizzle's
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int width) {
    if (p.vec && width == PF_DMAX) {
#pragma unroll
      for (int j = 0; j < PF_BK / RSTEP; ++j) {
        const int r = lr + RSTEP * j;
        __nv_bfloat16* d = dst + loff + RSTEP * 64 * j;
        if (row0 + r < S) {
          cp_async<16>(d, src + (size_t)(row0 + r) * PF_DMAX + lc);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else if (p.vec) {
      const int cpr = width / 8;  // the row's 16-byte pieces
      for (int idx = tid; idx < PF_BK * cpr; idx += PF_THREADS) {
        const int r = (idx / (8 * cpr)) * 8 + idx % 8, c = ((idx / 8) % cpr) * 8;
        __nv_bfloat16* d = dst + sw128_off(r, c);
        if (row0 + r < S) {
          cp_async<16>(d, src + (size_t)(row0 + r) * width + c);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int idx = tid; idx < PF_BK * width; idx += PF_THREADS) {
        const int r = idx / width, c = idx % width;
        dst[sw128_off(r, c)] = (row0 + r < S) ? src[(size_t)(row0 + r) * width + c] : zero;
      }
    }
  };
  auto k_stage = [&](int kt) { return k_s + ((kt - kt0) % PF_STAGES) * PF_TILE; };
  auto v_stage = [&](int kt) { return v_s + ((kt - kt0) % PF_STAGES) * PF_TILE; };
  auto refill = [&](int kt) {  // tile kt into the stage of tile kt - STAGES
    if (kt <= kt1) {
      load_rows(k_stage(kt), k, kt * PF_BK, D);
      load_rows(v_stage(kt), v, kt * PF_BK, Dv);
    }
    cp_async_commit();
  };
  for (int j = 0; j < PF_STAGES - 1; ++j) refill(kt0 + j);

  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group and column pair
  const int qa = wq0 + warp * 16 + g, qb = qa + 8;  // this thread's two query rows
  // Q's A fragments straight from device memory, once: rows qa and qb,
  // columns 16 kk + 2 t4 (+ 1) and 16 kk + 8 + 2 t4 (+ 1); zeros past S and D
  unsigned qf[PF_DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < PF_DMAX / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = (r & 1) ? qb : qa, d = kk * 16 + 8 * (r / 2) + 2 * t4;
      const __nv_bfloat16* src = q + (size_t)qi * D + d;
      if (p.vec && d + 1 < D) {
        qf[kk][r] = qi < S ? *reinterpret_cast<const unsigned*>(src) : 0u;
      } else {
        __nv_bfloat162 pair;
        pair.x = (qi < S && d < D) ? src[0] : zero;
        pair.y = (qi < S && d + 1 < D) ? src[1] : zero;
        qf[kk][r] = *reinterpret_cast<const unsigned*>(&pair);
      }
    }
  }
  float o[PF_DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < PF_DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {masked2, masked2}, l_r[2] = {0.f, 0.f};
  float sc[PF_BK / 8][4];      // S, then P, of this warp's 16 rows
  unsigned pa[PF_BK / 16][4];  // P as the A operand of P · V, 16 keys a step

  for (int kt = kt0; kt <= kt1; ++kt) {
    cp_async_wait<PF_STAGES - 2>();  // tile kt is in; the next ones stay in flight
    fence_proxy_async();             // ... for wgmma's reads too
    __syncthreads();  // ... for every thread; and every warp is done with tile kt - 1
    refill(kt + PF_STAGES - 1);  // into tile kt - 1's stage
    if (kt < wkt0 || kt > wkt1) continue;  // a tile only the other warpgroup's rows need

    // S = Q · Kᵀ (64 × 64), one wgmma per 16 of the head dim: column half
    // kk / 4 of the swizzled K stage, 32 bytes into its rows
    const __nv_bfloat16* kst = k_stage(kt);
#pragma unroll
    for (int n = 0; n < PF_BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_DMAX / 16; ++kk) {
      wgmma_m64n64k16(sc, qf[kk], wgmma_desc_sw128(kst + (kk / 4) * PF_BK * 64 + (kk % 4) * 16,
                                                   16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale and mask (only tiles that cross the diagonal, the pad or S),
    // then the online softmax of this thread's two rows
    const int k0 = kt * PF_BK;
    const bool edge = wfull || k0 + PF_BK - 1 > wq0 || k0 < pad || k0 + PF_BK > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < PF_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale2;
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qi = e < 2 ? qa : qb;
          s = kj >= S ? -INFINITY : ((kj <= qi && kj >= pad) ? s : masked2);
        }
        sc[n][e] = s;
        mx[e / 2] = fmaxf(mx[e / 2], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < PF_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(sc[n][e] - m_r[e / 2]);
        sc[n][e] = pe;
        rs[e / 2] += pe;
      }
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < PF_DMAX / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P · V, 16 keys a step: P's fragments become the A operand; V is
    // read transposed, its two column halves one atom (8 KB) apart
#pragma unroll
    for (int j = 0; j < PF_BK / 16; ++j) {
      pa[j][0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[j][1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[j][2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[j][3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
    }
    const __nv_bfloat16* vst = v_stage(kt);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PF_BK / 16; ++j) {
      wgmma_m64n128k16_tb(o, pa[j], wgmma_desc_sw128(vst + j * 16 * 64, PF_BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / l_r[i];
  }
#pragma unroll
  for (int n = 0; n < PF_DMAX / 8; ++n) {
    const int d = n * 8 + 2 * t4;
    if (d < Dv) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = i == 0 ? qa : qb;
        if (qi < S) {
          __nv_bfloat16* dst = p.out + ((size_t)b * S + qi) * p.H * Dv + (size_t)h * Dv + d;
          const float x0 = o[n][2 * i] * inv[i], x1 = o[n][2 * i + 1] * inv[i];
          if (Dv % 2 == 0) {  // d even: a 4-byte store
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
          } else {
            dst[0] = __float2bfloat16_rn(x0);
            if (d + 1 < Dv) dst[1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }
  }
}

inline cudaError_t launch_prefill_attention(const PrefillParams& p, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(prefill_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.S + PF_BQ - 1) / PF_BQ);
  prefill_attention_kernel<<<grid, PF_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dsocr

extern "C" int dsocr_flash_prefill_attention(
    const void* q, const void* k, const void* v, const void* pad_start, void* out,
    int B, int H, int Hkv, int S, int D, int Dv, float scale, int dtype, void* stream) {
  using namespace dsocr;
  if (D < 1 || Dv < 1 || D > FT_DMAX || Dv > FT_DMAX || H % Hkv != 0 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    PrefillParams p{};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.pad_start = static_cast<const int32_t*>(pad_start);
    p.B = B;
    p.H = H;
    p.Hkv = Hkv;
    p.S = S;
    p.D = D;
    p.Dv = Dv;
    p.scale = scale;
    p.vec = copy_chunk({(unsigned long long)D * 2, (unsigned long long)Dv * 2,
                        (unsigned long long)(uintptr_t)q, (unsigned long long)(uintptr_t)k,
                        (unsigned long long)(uintptr_t)v}) == 16;
    return (int)launch_prefill_attention(p, st);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  FlashParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.pad_start = static_cast<const int32_t*>(pad_start);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  p.scale = scale;
  return (int)launch_flash_tile<float>(p, st);
}
